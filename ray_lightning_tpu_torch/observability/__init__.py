"""Distributed flight recorder: spans, metrics and driver aggregation
(``ray_lightning_tpu/observability/``).

Public surface (everything off-by-default-cheap):

- :func:`span` / :func:`event` — trace API, no-op unless enabled.
- :func:`registry` — the process metrics registry, ``None`` unless enabled
  (call sites hold the ``None`` check as their only disabled-path cost).
- :func:`enable` / :func:`maybe_enable_from_env` — flip telemetry on
  (``TORCHRT_TELEMETRY=1`` or ``telemetry=True`` on a strategy).
- :func:`collect_beat_payload` — drain pending trace events + metric
  deltas for piggybacking on a heartbeat (``None`` when disabled/empty).

Driver-side pieces (:class:`~.aggregator.DriverAggregator`,
:func:`~.aggregator.render_top`) live in :mod:`.aggregator`; the serving
side's request tracer in :mod:`.reqtrace` and its SLO monitor in
:mod:`.slo`; the cost accounting, coordinated capture and step-time
attribution in :mod:`.profiler`, whose records ride the beats under ``"p"``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from . import goodput, metrics, profiler, reqtrace, slo, trace
from .trace import (  # noqa: F401  (re-exported API)
    DRIVER,
    NOOP_SPAN,
    TraceRecorder,
    disable,
    enable,
    enabled,
    env_enabled,
    estimate_skew,
    event,
    get_recorder,
    maybe_enable_from_env,
    merge_traces,
    span,
)

__all__ = [
    "DRIVER",
    "NOOP_SPAN",
    "TraceRecorder",
    "collect_beat_payload",
    "disable",
    "enable",
    "enabled",
    "env_enabled",
    "estimate_skew",
    "event",
    "get_recorder",
    "goodput",
    "maybe_enable_from_env",
    "merge_traces",
    "metrics",
    "profiler",
    "registry",
    "reqtrace",
    "reset",
    "sample_device_memory",
    "slo",
    "span",
    "trace",
]


def registry() -> Optional[metrics.MetricsRegistry]:
    """The process-local metrics registry, or ``None`` when telemetry is
    disabled — call sites gate their record path on this single check."""
    if trace.enabled():
        return metrics.get_registry()
    return None


def collect_beat_payload(final: bool = False) -> Optional[Dict[str, Any]]:
    """Drain telemetry for shipping on a heartbeat.

    Returns ``{"m": <metrics delta snapshot>, "t": <trace events>}`` or
    ``None`` when telemetry is disabled or (unless ``final``) there is
    nothing new to ship. ``final=True`` forces a full cumulative metrics
    snapshot so the driver's last view is complete even if some earlier
    delta beats were dropped. Pending profile records (cost, capture,
    attribution) ride along under ``"p"``, also with telemetry off, so that
    an env-armed profile window on a bare run still reports.
    """
    rec = trace.get_recorder()
    prof = profiler.drain_pending()
    if rec is None:
        return {"p": prof} if prof else None
    events = rec.drain()
    reg = metrics.get_registry()
    # goodput ledgers publish just-in-time so the wall-time counters on
    # this beat are current up to this instant
    goodput.publish_all(reg)
    snap = reg.snapshot(delta=not final)
    if not final and not events and not prof and reg.is_empty_snapshot(snap):
        return None
    payload: Dict[str, Any] = {"m": snap, "t": events}
    if prof:
        payload["p"] = prof
    return payload


def sample_device_memory(force: bool = False) -> None:
    """Throttled device-memory snapshot into the gauges; a no-op when
    telemetry is disabled, one clock read when the cache is fresh. The
    session's heartbeat calls this so the gauges ride the existing
    heartbeat channel."""
    if trace.enabled():
        metrics.publish_device_memory(metrics.get_registry(), force=force)


def reset() -> None:
    """Disable telemetry and drop all recorded state (test isolation)."""
    trace.disable()
    metrics.reset_registry()
    profiler.reset_pending()
    goodput.reset()
