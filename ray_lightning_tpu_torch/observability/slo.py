"""Declarative SLOs evaluated with multi-window burn rates
(``ray_lightning_tpu/observability/slo.py``).

An :class:`SLObjective` promises a good-event fraction (``target``) for
one signal: TTFT, ITL, step time, input starvation, error rate. The
:class:`BurnRateMonitor` classifies each observation good/bad and keeps
a time-bucketed window of counts; the *burn rate* is the fraction of bad
events divided by the error budget (``1 - target``), i.e. how many times
faster than allowed the budget is being spent.

Alerting follows the SRE multi-window recipe: a breach fires only when
**both** a fast window (default 60 s) and a slow window (default 600 s)
burn above their thresholds (the slow window keeps one latency spike
from paging, the fast window makes the alert and its reset prompt). The
breach clears as soon as the fast window recovers.

Verdict transitions are returned as event dicts (``slo_breach`` /
``slo_clear``) which the driver aggregator lands in ``events.jsonl``;
current burn rates publish as the ``rlt_slo_burn_rate`` gauge (labels
``objective``, ``window``) plus a 0/1 ``rlt_slo_breached`` gauge. A
breached verdict also feeds the :class:`~..serving.replica.Autoscaler`
(scale up, and never down, while burning), the engine's shed policy
(``InferenceEngine.slo_monitor``) and the supervisor's monitor mode.
Thresholds tune through the ``TORCHRT_SLO_*`` environment knobs.

Pure host logic: importing it starts nothing. Clocks are injectable
everywhere (``time.monotonic`` default) so burn windows are testable
without sleeping.
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

BURN_RATE_METRIC = "rlt_slo_burn_rate"
BREACHED_METRIC = "rlt_slo_breached"

DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 600.0
# Google SRE page-tier thresholds: the fast window must burn 14.4x budget
# (2% of a 30-day budget in an hour) and the slow window 6x.
DEFAULT_FAST_BURN = 14.4
DEFAULT_SLOW_BURN = 6.0

MAX_WINDOW_SAMPLES = 8192


@dataclass(frozen=True)
class SLObjective:
    """One declarative objective.

    ``kind="latency"``: observations are latency seconds, bad when the
    value exceeds ``threshold``. ``kind="ratio"``: good/bad counts are
    recorded directly (error rates). ``target`` is the promised good
    fraction; ``metric`` names the source metric the aggregator routes
    samples from.
    """

    name: str
    metric: str
    threshold: float
    target: float = 0.99
    kind: str = "latency"
    description: str = ""

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.target)


def _env_float(environ, key: str, default: float) -> float:
    try:
        return float(environ.get(key, default))
    except (TypeError, ValueError):
        return default


def default_objectives(environ=os.environ) -> List[SLObjective]:
    """The stock objectives; thresholds tune via ``TORCHRT_SLO_*`` env knobs."""
    return [
        SLObjective(
            "ttft_p95",
            metric="rlt_serve_ttft_seconds",
            threshold=_env_float(environ, "TORCHRT_SLO_TTFT_S", 2.0),
            target=0.95,
            description="serving time-to-first-token under threshold",
        ),
        SLObjective(
            "itl_p99",
            metric="rlt_serve_itl_seconds",
            threshold=_env_float(environ, "TORCHRT_SLO_ITL_S", 0.25),
            target=0.99,
            description="serving inter-token latency under threshold",
        ),
        SLObjective(
            "step_time",
            metric="rlt_step_time_seconds",
            threshold=_env_float(environ, "TORCHRT_SLO_STEP_S", 60.0),
            target=0.99,
            description="training step wall time under threshold",
        ),
        SLObjective(
            "input_starvation",
            metric="rlt_input_starved_seconds",
            threshold=_env_float(environ, "TORCHRT_SLO_STARVED_S", 0.05),
            target=0.95,
            description="per-beat input-starvation increase under threshold",
        ),
        SLObjective(
            "error_rate",
            metric="rlt_serve_completions_total",
            threshold=0.0,
            target=_env_float(environ, "TORCHRT_SLO_ERROR_TARGET", 0.999),
            kind="ratio",
            description="serving completions that are not errors",
        ),
    ]


def tenant_objectives(registry, environ=os.environ) -> List[SLObjective]:
    """Per-tenant TTFT objectives for every tenant in ``registry``
    (a ``serving.tenancy.TenantRegistry``).

    Objective names are ``tenant_ttft_<name>`` and every one shares the
    ``rlt_tenant_ttft_seconds`` metric — observations MUST route by
    objective name (``SLOMonitor.observe_latency("tenant_ttft_gold",
    ...)``), since metric routing would collapse all tenants onto the
    first monitor. Threshold: the tenant spec's ``ttft_slo_ms`` when
    set, else env ``TORCHRT_SLO_TENANT_TTFT_S`` (seconds, default 2.0)."""
    default_s = _env_float(environ, "TORCHRT_SLO_TENANT_TTFT_S", 2.0)
    out: List[SLObjective] = []
    for name in registry.names():
        spec = registry.spec(name)
        threshold = (
            float(spec.ttft_slo_ms) / 1e3
            if spec.ttft_slo_ms is not None
            else default_s
        )
        out.append(
            SLObjective(
                f"tenant_ttft_{name}",
                metric="rlt_tenant_ttft_seconds",
                threshold=threshold,
                target=0.95,
                description=(
                    f"tenant {name!r} time-to-first-token under threshold"
                ),
            )
        )
    return out


class BurnRateMonitor:
    """Good/bad window counts + multi-window burn-rate evaluation for one
    objective. Not thread-safe; callers serialize (the aggregator does)."""

    def __init__(
        self,
        objective: SLObjective,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        fast_burn: float = DEFAULT_FAST_BURN,
        slow_burn: float = DEFAULT_SLOW_BURN,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.objective = objective
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = max(float(slow_window_s), self.fast_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.clock = clock
        self.breached = False
        self.breaches_total = 0
        # lifetime totals (never windowed): whole-run attainment for
        # replay verdicts and post-hoc reports
        self.good_total = 0
        self.bad_total = 0
        self._samples: deque = deque(maxlen=MAX_WINDOW_SAMPLES)

    # ------------------------------------------------------------- #
    # ingestion
    # ------------------------------------------------------------- #
    def observe(self, value: float, now: Optional[float] = None) -> None:
        """Classify one latency-style observation against the threshold."""
        bad = float(value) > self.objective.threshold
        self.record(0 if bad else 1, 1 if bad else 0, now)

    def record(self, good: int, bad: int, now: Optional[float] = None) -> None:
        if good <= 0 and bad <= 0:
            return
        now = self.clock() if now is None else now
        self.good_total += int(good)
        self.bad_total += int(bad)
        self._samples.append((now, int(good), int(bad)))

    # ------------------------------------------------------------- #
    # evaluation
    # ------------------------------------------------------------- #
    def _counts(self, window_s: float, now: float):
        cutoff = now - window_s
        good = bad = 0
        for ts, g, b in self._samples:
            if ts >= cutoff:
                good += g
                bad += b
        return good, bad

    def attainment(self) -> Optional[float]:
        """Lifetime good fraction, or ``None`` with zero observations."""
        total = self.good_total + self.bad_total
        if total == 0:
            return None
        return self.good_total / total

    def burn_rate(self, window_s: float, now: Optional[float] = None) -> float:
        """Bad fraction over the window divided by the error budget."""
        now = self.clock() if now is None else now
        good, bad = self._counts(window_s, now)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / self.objective.error_budget

    def evaluate(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Advance the breach state machine; returns an ``slo_breach`` /
        ``slo_clear`` transition event dict, or ``None`` on no change."""
        now = self.clock() if now is None else now
        # drop samples older than the slow window so memory stays bounded
        cutoff = now - self.slow_window_s
        samples = self._samples
        while samples and samples[0][0] < cutoff:
            samples.popleft()
        fast = self.burn_rate(self.fast_window_s, now)
        slow = self.burn_rate(self.slow_window_s, now)
        firing = fast >= self.fast_burn and slow >= self.slow_burn
        transition: Optional[str] = None
        if firing and not self.breached:
            self.breached = True
            self.breaches_total += 1
            transition = "slo_breach"
        elif self.breached and fast < self.fast_burn:
            self.breached = False
            transition = "slo_clear"
        if transition is None:
            return None
        return {
            "event": transition,
            "objective": self.objective.name,
            "metric": self.objective.metric,
            "threshold": self.objective.threshold,
            "target": self.objective.target,
            "fast_burn_rate": round(fast, 3),
            "slow_burn_rate": round(slow, 3),
        }


def ttft_burn_attribution(reg) -> Optional[Dict[str, Any]]:
    """Name the TTFT component (and the pool it charges) dominating the
    ``rlt_serve_ttft_component_seconds`` histograms — the lineage layer's
    burn attribution. Because the components of one request sum to its
    measured TTFT, the component with the largest cumulative seconds IS
    where the fleet's TTFT budget is going; a ``queue_wait``-dominated
    breach points at prefill capacity, a ``decode``-dominated one at the
    decode pool, a ``transfer``-dominated one at the migration path.
    Returns ``None`` when no component samples exist."""
    totals: Dict[tuple, float] = {}
    grand = 0.0
    try:
        items = reg.items()
    except AttributeError:
        return None
    for (name, labels), metric in items:
        if name != "rlt_serve_ttft_component_seconds":
            continue
        seconds = float(getattr(metric, "sum", 0.0))
        component = dict(labels).get("component", "?")
        pool = dict(labels).get("pool", "?")
        key = (component, _POOL_FOR_COMPONENT.get(component, pool))
        totals[key] = totals.get(key, 0.0) + seconds
        grand += seconds
    if not totals or grand <= 0.0:
        return None
    (component, pool), seconds = max(totals.items(), key=lambda kv: kv[1])
    return {
        "dominant_component": component,
        "dominant_pool": pool,
        "component_share": round(seconds / grand, 3),
    }


# Which pool a TTFT component's seconds charge. Cumulative components are
# emitted by the first-token hop (its own pool label), but queue_wait and
# prefill seconds were spent on the PREFILL side and transfer/export on
# the migration path regardless of who emitted them.
_POOL_FOR_COMPONENT = {
    "queue_wait": "prefill",
    "prefill": "prefill",
    "export_wait": "migration",
    "transfer": "migration",
    "dispatch": "driver",
    "decode": "decode",
}


class SLOMonitor:
    """A set of burn-rate monitors with metric-name routing, gauge
    publication, and a fleet-level breached verdict."""

    def __init__(
        self,
        objectives: Optional[Sequence[SLObjective]] = None,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        fast_burn: float = DEFAULT_FAST_BURN,
        slow_burn: float = DEFAULT_SLOW_BURN,
        clock: Callable[[], float] = time.monotonic,
    ):
        objectives = (
            list(objectives) if objectives is not None else default_objectives()
        )
        self.monitors: Dict[str, BurnRateMonitor] = {
            o.name: BurnRateMonitor(
                o, fast_window_s, slow_window_s, fast_burn, slow_burn, clock
            )
            for o in objectives
        }
        self._by_metric: Dict[str, BurnRateMonitor] = {}
        for m in self.monitors.values():
            self._by_metric.setdefault(m.objective.metric, m)

    def monitor_for_metric(self, metric: str) -> Optional[BurnRateMonitor]:
        return self._by_metric.get(metric)

    def observe_latency(
        self, name_or_metric: str, value: float, now: Optional[float] = None
    ) -> None:
        m = self.monitors.get(name_or_metric) or self._by_metric.get(
            name_or_metric
        )
        if m is not None and m.objective.kind == "latency":
            m.observe(value, now)

    def record(
        self, name: str, good: int, bad: int, now: Optional[float] = None
    ) -> None:
        m = self.monitors.get(name)
        if m is not None:
            m.record(good, bad, now)

    def attainment(self, name: str) -> Optional[float]:
        """Lifetime attainment of one objective (None = no data)."""
        m = self.monitors.get(name)
        return m.attainment() if m is not None else None

    def breached(self, name: Optional[str] = None) -> bool:
        if name is not None:
            m = self.monitors.get(name)
            return bool(m and m.breached)
        return any(m.breached for m in self.monitors.values())

    def serving_breached(self) -> bool:
        """Breach verdict restricted to serving-path objectives (metric
        name ``rlt_serve_*``, e.g. TTFT/ITL) — the signal the engine's
        shed policy couples to, so a TRAINER objective burning budget
        (step time, input starvation) never sheds serving traffic."""
        return any(
            m.breached
            for m in self.monitors.values()
            if m.objective.metric.startswith("rlt_serve_")
        )

    def serving_fast_burn(self, now: Optional[float] = None) -> float:
        """Worst fast-window burn rate across serving-path objectives
        (metric name ``rlt_serve_*``) — the ChipArbiter's borrow signal:
        a fast burn above its threshold means serving is eating error
        budget NOW and a chip should move before the slow window
        confirms a full breach."""
        return max(
            (
                m.burn_rate(m.fast_window_s, now)
                for m in self.monitors.values()
                if m.objective.metric.startswith("rlt_serve_")
            ),
            default=0.0,
        )

    def burn_rates(self, now: Optional[float] = None) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, m in self.monitors.items():
            out[name] = {
                "fast": m.burn_rate(m.fast_window_s, now),
                "slow": m.burn_rate(m.slow_window_s, now),
                "breached": 1.0 if m.breached else 0.0,
            }
        return out

    def evaluate(
        self, now: Optional[float] = None, reg=None
    ) -> List[Dict[str, Any]]:
        """Evaluate every objective; publish gauges when ``reg`` is given;
        return the list of breach/clear transition events (often empty).

        A TTFT breach verdict is annotated with its dominant lineage
        component (``dominant_component`` / ``dominant_pool`` /
        ``component_share`` — see :func:`ttft_burn_attribution`), so the
        alert names WHERE the time went, not just that it went."""
        verdicts: List[Dict[str, Any]] = []
        for m in self.monitors.values():
            v = m.evaluate(now)
            if v is not None:
                if (
                    v["event"] == "slo_breach"
                    and v.get("metric") == "rlt_serve_ttft_seconds"
                    and reg is not None
                ):
                    attr = ttft_burn_attribution(reg)
                    if attr is not None:
                        v.update(attr)
                verdicts.append(v)
        if reg is not None:
            for name, m in self.monitors.items():
                reg.gauge(
                    BURN_RATE_METRIC, objective=name, window="fast"
                ).set(m.burn_rate(m.fast_window_s, now))
                reg.gauge(
                    BURN_RATE_METRIC, objective=name, window="slow"
                ).set(m.burn_rate(m.slow_window_s, now))
                reg.gauge(BREACHED_METRIC, objective=name).set(
                    1.0 if m.breached else 0.0
                )
        return verdicts
