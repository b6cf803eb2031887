"""Online anomaly detection over the driver's telemetry streams
(``ray_lightning_tpu/observability/anomaly.py``).

Detectors are deliberately simple and robust: a rolling median/MAD
baseline with a z-score threshold and a consecutive-exceedance count, so
a single noisy sample never fires but a sustained shift does. Four
detectors cover the failure modes the fault matrix injects:

- ``step_time`` — fleet step-time samples drift high (slow fault, thermal
  throttle, input regression that survived the pipeline),
- ``itl_p99`` — serving inter-token-latency p99 drifts against its own
  history (decode regressions that never breach the SLO outright),
- ``straggler`` — one rank's recent median step time pulls away from the
  other ranks' (per-rank drift the fleet-wide baseline would absorb),
- ``silent_goodput`` — the goodput fraction drops with *no* fault event
  in the flight record: the alarm for degradation nothing else explains.

Each firing emits one flight-record event (``anomaly_<detector>``) —
which the driver routes through the incident recorder — and maintains
``rlt_anomaly_score{detector}`` / ``rlt_anomaly_events_total{detector}``.
Detectors latch while anomalous and re-arm on recovery, so a sustained
condition produces one event, not one per evaluation tick.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from . import metrics as _metrics

ANOMALY_SCORE_METRIC = "rlt_anomaly_score"
ANOMALY_EVENTS_METRIC = "rlt_anomaly_events_total"

# Robust z-score: 0.6745 scales MAD to the stddev of a normal dist.
_MAD_SCALE = 0.6745
# Degenerate-MAD floor as a fraction of the median (a perfectly steady
# baseline would otherwise make any jitter an infinite z-score).
_MAD_FLOOR_FRAC = 0.05


def robust_z(value: float, baseline: List[float]) -> float:
    """MAD-based z-score of ``value`` against ``baseline`` samples."""
    med = _metrics.percentile(baseline, 50)
    mad = _metrics.percentile([abs(x - med) for x in baseline], 50)
    mad = max(mad, abs(med) * _MAD_FLOOR_FRAC, 1e-9)
    return _MAD_SCALE * (value - med) / mad


class RollingBaseline:
    """Bounded sample window with MAD z-scoring and k-consecutive firing.

    ``add(value)`` returns the z-score of the value against the *prior*
    window (None during warm-up). Anomalous samples are not folded into
    the baseline — a sustained regression must not normalize itself."""

    def __init__(
        self,
        window: int = 128,
        min_samples: int = 16,
        threshold: float = 6.0,
        consecutive: int = 3,
    ) -> None:
        self.window = deque(maxlen=int(window))  # type: Deque[float]
        self.min_samples = int(min_samples)
        self.threshold = float(threshold)
        self.consecutive = int(consecutive)
        self.exceedances = 0
        self.last_z = 0.0

    def add(self, value: float) -> Optional[float]:
        if len(self.window) < self.min_samples:
            self.window.append(value)
            self.last_z = 0.0
            return None
        z = robust_z(value, list(self.window))
        self.last_z = z
        if z >= self.threshold:
            self.exceedances += 1
        else:
            self.exceedances = 0
            self.window.append(value)
        return z

    @property
    def firing(self) -> bool:
        return self.exceedances >= self.consecutive


class _Latch:
    """One event per excursion: fires on the rising edge, re-arms when
    the condition clears."""

    def __init__(self) -> None:
        self.active = False

    def update(self, condition: bool) -> bool:
        fired = condition and not self.active
        self.active = condition
        return fired


class AnomalyMonitor:
    """Drives the detectors off the aggregator's ingest/summary cadence.

    ``observe_step`` / ``observe_itl`` feed raw samples as beats arrive;
    ``evaluate`` runs the windowed detectors (straggler drift, silent
    goodput degradation), publishes gauges, and returns the flight-record
    events to emit."""

    def __init__(
        self,
        clock: Callable[[], float] = time.time,
        step_threshold: float = 6.0,
        itl_threshold: float = 6.0,
        straggler_ratio: float = 1.75,
        straggler_consecutive: int = 3,
        goodput_drop: float = 0.25,
        fault_quiet_s: float = 120.0,
    ) -> None:
        self._clock = clock
        self.step = RollingBaseline(threshold=step_threshold)
        self.itl = RollingBaseline(threshold=itl_threshold)
        self._step_latch = _Latch()
        self._itl_latch = _Latch()
        # straggler drift: per-rank recent samples + consecutive counts
        self.straggler_ratio = float(straggler_ratio)
        self.straggler_consecutive = int(straggler_consecutive)
        self._rank_recent: Dict[Any, Deque[float]] = {}
        self._rank_drift: Dict[Any, int] = {}
        self._straggler_latch: Dict[Any, _Latch] = {}
        # silent degradation: baseline over observed goodput fractions
        self.goodput_drop = float(goodput_drop)
        self.fault_quiet_s = float(fault_quiet_s)
        self._fraction_baseline: Deque[float] = deque(maxlen=64)
        self._silent_latch = _Latch()
        self._silent_score = 0.0

    # -- sample feeds ----------------------------------------------------

    def observe_step(self, rank: Any, value: float) -> None:
        self.step.add(value)
        self._rank_recent.setdefault(rank, deque(maxlen=64)).append(value)

    def observe_itl(self, value: float) -> None:
        self.itl.add(value)

    def drop_rank(self, rank: Any) -> None:
        self._rank_recent.pop(rank, None)
        self._rank_drift.pop(rank, None)
        self._straggler_latch.pop(rank, None)

    # -- evaluation ------------------------------------------------------

    def evaluate(
        self,
        reg: Optional[Any] = None,
        goodput_fraction: Optional[float] = None,
        last_fault_ts: Optional[float] = None,
        now: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        now = self._clock() if now is None else now
        events: List[Dict[str, Any]] = []

        if self._step_latch.update(self.step.firing):
            events.append({
                "event": "anomaly_step_time",
                "detector": "step_time",
                "z": round(self.step.last_z, 2),
                "threshold": self.step.threshold,
            })
        if self._itl_latch.update(self.itl.firing):
            events.append({
                "event": "anomaly_itl_p99",
                "detector": "itl_p99",
                "z": round(self.itl.last_z, 2),
                "threshold": self.itl.threshold,
            })

        events.extend(self._evaluate_stragglers())
        events.extend(
            self._evaluate_silent(goodput_fraction, last_fault_ts, now)
        )

        if reg is not None:
            reg.gauge(ANOMALY_SCORE_METRIC, detector="step_time").set(
                round(self.step.last_z, 3)
            )
            reg.gauge(ANOMALY_SCORE_METRIC, detector="itl_p99").set(
                round(self.itl.last_z, 3)
            )
            reg.gauge(ANOMALY_SCORE_METRIC, detector="silent_goodput").set(
                round(self._silent_score, 3)
            )
            for ev in events:
                reg.counter(
                    ANOMALY_EVENTS_METRIC, detector=ev["detector"]
                ).inc()
        return events

    def _evaluate_stragglers(self) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        medians = {
            r: _metrics.percentile(list(s), 50)
            for r, s in self._rank_recent.items()
            if len(s) >= 8
        }
        if len(medians) < 2:
            return events
        for rank, med in medians.items():
            others = [m for r, m in medians.items() if r != rank]
            ref = _metrics.percentile(others, 50)
            drifting = ref > 0 and med / ref >= self.straggler_ratio
            count = self._rank_drift.get(rank, 0) + 1 if drifting else 0
            self._rank_drift[rank] = count
            latch = self._straggler_latch.setdefault(rank, _Latch())
            if latch.update(count >= self.straggler_consecutive):
                events.append({
                    "event": "anomaly_straggler",
                    "detector": "straggler",
                    "rank": rank,
                    "median_s": round(med, 6),
                    "fleet_median_s": round(ref, 6),
                    "ratio": round(med / ref, 2),
                })
        return events

    def _evaluate_silent(
        self,
        fraction: Optional[float],
        last_fault_ts: Optional[float],
        now: float,
    ) -> List[Dict[str, Any]]:
        if fraction is None:
            return []
        base = list(self._fraction_baseline)
        degraded = False
        if len(base) >= 8:
            ref = _metrics.percentile(base, 50)
            self._silent_score = max(0.0, ref - fraction)
            degraded = ref - fraction >= self.goodput_drop
        else:
            self._silent_score = 0.0
        fault_recent = (
            last_fault_ts is not None
            and now - last_fault_ts < self.fault_quiet_s
        )
        if not degraded:
            # healthy fractions feed the baseline; degraded ones must not
            # normalize the regression away
            self._fraction_baseline.append(fraction)
        if self._silent_latch.update(degraded and not fault_recent):
            return [{
                "event": "anomaly_silent_goodput",
                "detector": "silent_goodput",
                "fraction": round(fraction, 4),
                "baseline": round(_metrics.percentile(base, 50), 4),
                "drop": round(self._silent_score, 4),
            }]
        return []
