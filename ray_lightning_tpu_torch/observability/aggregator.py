"""Driver-side telemetry aggregation (``ray_lightning_tpu/observability/
aggregator.py``).

The :class:`DriverAggregator` sits behind the supervisor's heartbeat drain
loop — every worker beat (optionally carrying a telemetry payload of
metric snapshots + drained trace events, see ``session.py``) flows through
:meth:`on_beat`. No new connections: the heartbeat queue built for hang
detection *is* the telemetry transport.

It maintains:

- per-rank clock-skew estimates from beat ``(send_wall, recv_wall)`` pairs,
- per-rank trace-event buffers merged into one Chrome ``trace.json``,
- a driver-side :class:`~.metrics.MetricsRegistry` with every worker series
  relabelled ``rank=N`` (JSON + Prometheus text exporters),
- per-rank step-time sample streams -> straggler percentiles and cross-rank
  skew,
- an **always-on** JSONL flight record (``events.jsonl``) of supervisor
  verdicts and run lifecycle, written even when full telemetry is off.

``render_top`` implements the ``rlt top``-style live summary consumed by
``python -m ray_lightning_tpu_torch.cli top`` — it re-reads the throttled
``summary.json`` the aggregator drops next to the trace.

An ``slo_monitor`` (``slo.SLOMonitor``) is fed from the workers' metric
snapshots (latency histograms' samples, counter deltas) and evaluated at
every beat: its ``slo_breach`` / ``slo_clear`` verdicts land in
``events.jsonl`` (a breach also freezes an incident bundle) and its burn
rates in the summary's ``slo`` section. The profiler's ``"p"`` records
(``ingest_profile``) fold into the summary's ``profile`` section.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ray_lightning_tpu_torch.utils import fsio

from . import anomaly as _anomaly
from . import goodput as _goodput
from . import incidents as _incidents
from . import lineage as _lineage
from . import metrics as _metrics
from . import reqtrace as _reqtrace
from . import trace as _trace

TRACE_FILE = "trace.json"
METRICS_FILE = "metrics.json"
PROM_FILE = "metrics.prom"
EVENTS_FILE = "events.jsonl"
SUMMARY_FILE = "summary.json"
REQUESTS_FILE = _reqtrace.REQUESTS_FILE

DIR_ENV = "TORCHRT_TELEMETRY_DIR"

# caps so a long run cannot grow driver memory unboundedly
MAX_EVENTS_PER_RANK = 50_000
MAX_SKEW_SAMPLES = 512
MAX_STEP_SAMPLES = 8192

STEP_TIME_METRIC = "rlt_step_time_seconds"
ITL_METRIC = "rlt_serve_itl_seconds"

# Event kinds that *explain* a goodput drop — their recency arms the
# silent-degradation detector's quiet gate.
FAULT_EVENT_KINDS = frozenset({
    "crash", "hang", "straggler", "slo_breach", "elastic_shrink",
    "elastic_grow", "elastic_grow_failed", "arbiter_rollback",
    "arbiter_transfer", "serve_replica_drain",
})


def telemetry_dir(default_root_dir: Optional[str] = None) -> str:
    """Resolve the output directory: TORCHRT_TELEMETRY_DIR wins, else
    ``<default_root_dir>/telemetry``, else ``./telemetry``."""
    env = os.environ.get(DIR_ENV)
    if env:
        return env
    root = default_root_dir or os.getcwd()
    return os.path.join(root, "telemetry")


def step_time_stats(samples_by_rank: Dict[Any, List[float]]) -> Dict[str, float]:
    """Straggler statistics over per-rank step-time samples (seconds).

    ``step_time_max_skew`` is the spread between the slowest and fastest
    rank's median step time — the quantity that predicts multi-worker
    throughput cliffs. With a single rank it degrades to the in-rank
    max-min spread so bench rows still capture variance.
    """
    pooled: List[float] = []
    medians: List[float] = []
    for samples in samples_by_rank.values():
        if samples:
            pooled.extend(samples)
            medians.append(_metrics.percentile(samples, 50))
    if not pooled:
        return {}
    if len(medians) > 1:
        skew = max(medians) - min(medians)
    else:
        skew = max(pooled) - min(pooled)
    return {
        "step_time_p50": round(_metrics.percentile(pooled, 50), 6),
        "step_time_p90": round(_metrics.percentile(pooled, 90), 6),
        "step_time_max_skew": round(skew, 6),
    }


class DriverAggregator:
    """Collects worker telemetry off the heartbeat channel on the driver.

    ``full=False`` (telemetry disabled) degrades to flight-record-only
    mode: beats still update liveness gauges and verdicts still land in
    ``events.jsonl``, but no trace/metrics files are produced.
    """

    def __init__(
        self,
        run_dir: str,
        num_workers: int,
        full: bool = True,
        summary_interval: float = 2.0,
        slo_monitor: Optional[Any] = None,
    ):
        self.run_dir = run_dir
        self.num_workers = int(num_workers)
        self.full = bool(full)
        self.slo = slo_monitor
        self.registry = _metrics.MetricsRegistry()
        self._trace_by_rank: Dict[Any, deque] = {}
        self._skew_samples: Dict[Any, deque] = {}
        self._step_samples: Dict[Any, deque] = {}
        self._last_step: Dict[Any, int] = {}
        self._last_beat: Dict[Any, float] = {}
        self._rank_gauges: Dict[Any, Dict[str, float]] = {}
        self._profile_cost: Dict[str, dict] = {}
        self._profile_captures: Dict[Any, dict] = {}
        self._profile_attr: Dict[Any, dict] = {}
        # (rank, counter, labels) -> the value last fed to the SLO monitor
        self._slo_counter_last: Dict[Any, float] = {}
        self._events = _reqtrace.JsonlWriter(os.path.join(run_dir, EVENTS_FILE))
        self._requests: Optional[_reqtrace.JsonlWriter] = None
        self.requests_total = 0
        self._elastic: Optional[Dict[str, Any]] = None
        self._summary_interval = float(summary_interval)
        self._summary_written = 0.0
        self._finalized = False
        # goodput fold: rank -> src -> {category: cumulative seconds}
        self._goodput: Dict[Any, Dict[str, Dict[str, float]]] = {}
        self._last_fault_ts: Optional[float] = None
        self.anomaly = _anomaly.AnomalyMonitor() if self.full else None
        self.incidents = _incidents.IncidentRecorder(
            run_dir,
            registry=self.registry,
            events_path=self._events.path,
            trace_provider=self._trace_slice,
        )
        # every incident bundle freezes a lineage slice: the stitched
        # causal timelines of recent requests, led by the rids the TTFT
        # histogram's slow buckets name
        self.incidents.register_source("lineage", self._lineage_slice)
        os.makedirs(run_dir, exist_ok=True)
        self._prom: Optional[_metrics.PromServer] = None
        port = _metrics.prom_port_from_env()
        if port is not None and self.full:
            try:
                self._prom = _metrics.PromServer(
                    self.registry.prometheus_text, port
                )
                bound = self._prom.start()
                self.record_event("prom_endpoint", port=bound)
            except OSError as e:
                self._prom = None
                self.record_event("prom_endpoint_failed", error=str(e))

    # ----------------------------------------------------------------- #
    # ingestion (called from the supervisor thread)
    # ----------------------------------------------------------------- #
    def on_beat(
        self,
        rank: int,
        step: int,
        send_wall: float,
        payload: Optional[dict] = None,
        recv_wall: Optional[float] = None,
    ) -> None:
        recv = time.time() if recv_wall is None else recv_wall
        self._last_step[rank] = int(step)
        self._last_beat[rank] = recv
        self._skew_samples.setdefault(rank, deque(maxlen=MAX_SKEW_SAMPLES)).append(
            (send_wall, recv)
        )
        reg = self.registry
        reg.gauge("rlt_heartbeat_latency_seconds", rank=rank).set(recv - send_wall)
        reg.gauge("rlt_worker_step", rank=rank).set(step)
        if payload:
            self.ingest_payload(rank, payload)
        self._evaluate_slo()
        self._maybe_write_summary(recv)

    def ingest_payload(self, rank: int, payload: dict) -> None:
        events = payload.get("t")
        if events:
            buf = self._trace_by_rank.setdefault(
                rank, deque(maxlen=MAX_EVENTS_PER_RANK)
            )
            buf.extend(events)
        for rec in payload.get("r", ()):
            self.record_request(rec, rank=rank)
        for rec in payload.get("p", ()) or ():
            self.ingest_profile(rank, rec)
        snap = payload.get("m")
        if snap:
            self.registry.merge_snapshot(snap, extra_labels={"rank": rank})
            gauges = self._rank_gauges.setdefault(rank, {})
            hbm_seen: Dict[str, float] = {}
            for name, labels, value in snap.get("gauges", ()):
                if not labels:
                    gauges[name] = value
                elif name in (
                    _metrics.HBM_IN_USE_METRIC, _metrics.HBM_PEAK_METRIC
                ):
                    # device-labelled: fold to the rank's worst device
                    hbm_seen[name] = max(hbm_seen.get(name, 0.0), value)
            gauges.update(hbm_seen)
            # counters are cumulative at the source, so latest-wins like
            # gauges; the input-starved total feeds the summary/top view
            for name, labels, value in snap.get("counters", ()):
                if not labels:
                    gauges[name] = value
                elif name == _goodput.GOODPUT_SECONDS_METRIC:
                    d = dict(labels)
                    cat = d.get("category")
                    if cat:
                        self._goodput.setdefault(rank, {}).setdefault(
                            d.get("src", "train"), {}
                        )[cat] = value
            for name, labels, h in snap.get("histograms", ()):
                if name == STEP_TIME_METRIC:
                    samples = h.get("samples", ())
                    self._step_samples.setdefault(
                        rank, deque(maxlen=MAX_STEP_SAMPLES)
                    ).extend(samples)
                    if self.anomaly is not None:
                        for v in samples:
                            self.anomaly.observe_step(rank, v)
                elif name == ITL_METRIC and self.anomaly is not None:
                    for v in h.get("samples", ()):
                        self.anomaly.observe_itl(v)
            if self.slo is not None:
                self._feed_slo(rank, snap)

    def ingest_profile(self, rank: int, rec: Any) -> None:
        """One profiler record off a beat payload (``"p"`` key): ``cost``
        records are latest-wins per program (measured, MFU-bearing ones
        beat analytic-only ones), ``capture``/``attribution`` records are
        latest-wins per rank. Captures land in the flight record so the
        trace directories survive even without a summary."""
        if not isinstance(rec, dict):
            return
        rec = dict(rec)
        rec.setdefault("rank", rank)
        kind = rec.get("kind")
        if kind == "cost":
            program = str(rec.get("program", "train_step"))
            old = self._profile_cost.get(program)
            new_measured = "mfu" in (rec.get("roofline") or {})
            old_measured = old is not None and "mfu" in (old.get("roofline") or {})
            if old is None or new_measured or not old_measured:
                self._profile_cost[program] = rec
        elif kind == "capture":
            self._profile_captures[rank] = rec
            self.record_event(
                "profile_capture",
                rank=rank,
                trace_dir=rec.get("trace_dir"),
                start_step=rec.get("start_step"),
                steps=rec.get("num_steps"),
            )
        elif kind == "attribution":
            self._profile_attr[rank] = rec

    def drop_rank(self, rank: Any) -> None:
        """Forget live state for a rank evicted by elastic shrink, so
        summaries and Prometheus output stop reporting the dead worker.
        Trace-event buffers are kept — history already recorded belongs
        in the merged trace."""
        for store in (
            self._rank_gauges,
            self._step_samples,
            self._skew_samples,
            self._last_step,
            self._last_beat,
            self._profile_captures,
            self._profile_attr,
        ):
            store.pop(rank, None)
        self._slo_counter_last = {
            k: v for k, v in self._slo_counter_last.items() if k[0] != rank
        }
        self._goodput.pop(rank, None)
        if self.anomaly is not None:
            self.anomaly.drop_rank(rank)
        self.registry.drop_series(rank=rank)
        self.record_event("rank_dropped", rank=rank)

    # ----------------------------------------------------------------- #
    # SLO routing: worker metric snapshots -> burn-rate observations
    # ----------------------------------------------------------------- #
    def _feed_slo(self, rank: int, snap: dict) -> None:
        slo = self.slo
        for name, labels, h in snap.get("histograms", ()):
            m = slo.monitor_for_metric(name)
            if m is not None and m.objective.kind == "latency":
                for v in h.get("samples", ()):
                    m.observe(v)
        for name, labels, value in snap.get("counters", ()):
            m = slo.monitor_for_metric(name)
            if m is None:
                continue
            key = (rank, name, tuple(labels))
            delta = value - self._slo_counter_last.get(key, 0.0)
            self._slo_counter_last[key] = value
            if delta <= 0:
                continue
            if m.objective.kind == "ratio":
                # serving completions: `reason=error` burns budget
                bad = dict(labels).get("reason") == "error"
                m.record(0 if bad else int(delta), int(delta) if bad else 0)
            else:
                # cumulative-seconds counters (input starvation): the
                # per-beat increase is the latency-style observation
                m.observe(delta)

    def _evaluate_slo(self) -> None:
        if self.slo is None:
            return
        for v in self.slo.evaluate(reg=self.registry):
            self.record_event(v.pop("event"), **v)

    def heartbeat_age(self, rank: int, age: float) -> None:
        """Supervisor-reported time since a rank's last beat."""
        self.registry.gauge("rlt_heartbeat_age_seconds", rank=rank).set(age)

    def set_elastic(
        self,
        world_size: int,
        membership_epoch: int,
        shrinks: int = 0,
        grows: int = 0,
        recovery_s: Optional[float] = None,
    ) -> None:
        """Elastic membership controller state: current world size, the
        membership epoch counter, cumulative resize counts, and (when a
        resize just completed) its wall-clock recovery time."""
        self._elastic = {
            "world_size": int(world_size),
            "membership_epoch": int(membership_epoch),
            "shrinks": int(shrinks),
            "grows": int(grows),
        }
        if recovery_s is not None:
            self._elastic["last_recovery_s"] = round(float(recovery_s), 3)
        reg = self.registry
        reg.gauge("rlt_elastic_world_size").set(world_size)
        reg.gauge("rlt_elastic_membership_epoch").set(membership_epoch)
        # counters carry cumulative totals from the controller: latest-wins
        reg.counter("rlt_elastic_resizes_total", kind="shrink").value = float(shrinks)
        reg.counter("rlt_elastic_resizes_total", kind="grow").value = float(grows)
        if recovery_s is not None:
            reg.histogram("rlt_elastic_recovery_seconds").observe(recovery_s)

    def record_event(self, kind: str, **fields) -> None:
        """Append one line to the JSONL flight record (always on, rotated
        at ``TORCHRT_EVENTS_MAX_BYTES``) and mirror it as an instant event on
        the driver's trace track."""
        line = {"ts": time.time(), "event": kind}
        line.update(
            {k: (v if isinstance(v, (int, float, bool, type(None))) else str(v))
             for k, v in fields.items()}
        )
        self._events.write(line)
        _trace.event(f"verdict/{kind}" if kind in (
            "crash", "hang", "straggler") else kind, **fields)
        if kind in FAULT_EVENT_KINDS:
            self._last_fault_ts = line["ts"]
        if kind in _incidents.INCIDENT_EVENT_KINDS:
            # the triggering line is already flushed, so the bundle's
            # event window covers its own cause
            self.incidents.maybe_capture(kind, event=line)

    def record_request(self, record: dict, rank: Optional[int] = None) -> None:
        """One finished-request record (from a replica's beat payload or a
        local engine) into the fleet-wide ``requests.jsonl``."""
        if not self.full:
            return
        if self._requests is None:
            self._requests = _reqtrace.JsonlWriter(
                os.path.join(self.run_dir, REQUESTS_FILE)
            )
        if rank is not None and "rank" not in record:
            record = dict(record, rank=rank)
        self._requests.write(record)
        self.requests_total += 1

    # ----------------------------------------------------------------- #
    # aggregation
    # ----------------------------------------------------------------- #
    def skew_by_rank(self) -> Dict[Any, float]:
        return {
            rank: _trace.estimate_skew(list(samples))
            for rank, samples in self._skew_samples.items()
        }

    def register_incident_source(self, name: str, fn) -> None:
        """Expose a ledger/journal snapshot to future incident bundles."""
        self.incidents.register_source(name, fn)

    def _lineage_slice(self) -> Dict[str, Any]:
        """Frozen lineage slice for an incident bundle: stitched causal
        timelines reconstructed from the trailing window of the fleet
        ``requests.jsonl`` (rotation-stitched, skew-corrected). Prefers
        the base rids named by the TTFT histogram's bucket exemplars —
        the offending requests — and falls back to the most recent
        lineages when no exemplars exist."""
        path = os.path.join(self.run_dir, REQUESTS_FILE)
        lineages = _lineage.lineages_from_window(
            path, skew_by_rank=self.skew_by_rank()
        )
        exemplar_rids = set()
        for (name, _labels), m in self.registry.items():
            if name != "rlt_serve_ttft_seconds":
                continue
            for ids in getattr(m, "exemplars", {}).values():
                exemplar_rids.update(
                    _reqtrace.base_rid(str(r)) for r in ids
                )
        picked = sorted(b for b in exemplar_rids if b in lineages)
        if not picked:
            picked = sorted(lineages)[-16:]
        return {
            "requests_total": self.requests_total,
            "lineages": [_lineage.summary(lineages[b]) for b in picked],
        }

    def _trace_slice(self, limit: int = 2000) -> Dict[str, Any]:
        """Merged Chrome-trace slice of the recent per-rank tails plus the
        driver ring (non-destructive peek), for incident bundles."""
        events_by_rank: Dict[Any, List[_trace.TraceTuple]] = {
            r: list(buf)[-limit:] for r, buf in self._trace_by_rank.items()
        }
        rec = _trace.get_recorder()
        if rec is not None:
            events_by_rank[_trace.DRIVER] = rec.peek(limit)
        return _trace.merge_traces(events_by_rank, self.skew_by_rank())

    def goodput_summary(self) -> Dict[str, Any]:
        """Fold per-(rank, src) goodput ledgers — beats from workers plus
        any ledgers living in this process (driver bookkeeping, local
        serve engines) — into the fleet-level section, and publish the
        fleet counters + fraction gauge."""
        per: Dict[Any, Dict[str, float]] = {}
        seen_srcs = set()
        for rank, srcs in self._goodput.items():
            for src, cats in srcs.items():
                key = str(rank) if src == "train" else f"{rank}/{src}"
                per[key] = dict(cats)
                seen_srcs.add(src)
        # process-local ledgers not already reported through a beat (the
        # in-process path publishes via write_local_dump/ingest instead)
        for src, led in _goodput.ledgers().items():
            if src in seen_srcs:
                continue
            per[f"driver/{src}"] = led.snapshot()
        folded = _goodput.fold(per)
        if folded["total_s"] > 0:
            reg = self.registry
            for cat, secs in folded["by_category"].items():
                reg.counter(
                    _goodput.GOODPUT_SECONDS_METRIC, category=cat
                ).value = secs
            reg.gauge(_goodput.GOODPUT_FRACTION_METRIC).set(folded["fraction"])
        return folded

    def step_samples_by_rank(self) -> Dict[Any, List[float]]:
        return {r: list(s) for r, s in self._step_samples.items()}

    def summary(self) -> Dict[str, Any]:
        now = time.time()
        skews = self.skew_by_rank()
        per_rank: Dict[str, Any] = {}
        samples_total = 0.0
        mfus: List[float] = []
        for rank in sorted(
            set(self._last_step) | set(self._step_samples), key=str
        ):
            samples = list(self._step_samples.get(rank, ()))
            gauges = self._rank_gauges.get(rank, {})
            info: Dict[str, Any] = {
                "step": self._last_step.get(rank),
                "clock_skew_s": round(skews.get(rank, 0.0), 6),
                "heartbeat_age_s": round(
                    now - self._last_beat[rank], 3
                ) if rank in self._last_beat else None,
                "n_step_samples": len(samples),
            }
            if samples:
                info["step_time_p50"] = round(_metrics.percentile(samples, 50), 6)
                info["step_time_p90"] = round(_metrics.percentile(samples, 90), 6)
            for name, key in (
                ("rlt_samples_per_sec", "samples_per_sec"),
                ("rlt_train_mfu", "mfu"),
                ("rlt_tokens_per_sec_per_chip", "tokens_per_sec_per_chip"),
                ("rlt_input_starved_seconds", "input_starved_s"),
                ("rlt_prefetch_queue_depth", "prefetch_queue_depth"),
                (_metrics.HBM_IN_USE_METRIC, "hbm_bytes_in_use"),
                (_metrics.HBM_PEAK_METRIC, "hbm_peak_bytes"),
            ):
                if name in gauges:
                    info[key] = round(gauges[name], 6)
            samples_total += info.get("samples_per_sec", 0.0) or 0.0
            if "mfu" in info:
                mfus.append(info["mfu"])
            per_rank[str(rank)] = info
        cluster: Dict[str, Any] = dict(
            step_time_stats(self.step_samples_by_rank())
        )
        if samples_total:
            cluster["samples_per_sec"] = round(samples_total, 3)
        if mfus:
            cluster["mfu"] = round(sum(mfus) / len(mfus), 6)
        starved = [
            info["input_starved_s"]
            for info in per_rank.values()
            if "input_starved_s" in info
        ]
        if starved:
            cluster["input_starved_s"] = round(max(starved), 6)
        hbm = [
            info["hbm_bytes_in_use"]
            for info in per_rank.values()
            if "hbm_bytes_in_use" in info
        ]
        if hbm:
            cluster["hbm_bytes_in_use"] = round(max(hbm))
        steps = [s for s in self._last_step.values() if s is not None]
        if steps:
            cluster["steps_min"] = min(steps)
            cluster["steps_max"] = max(steps)
        out = {
            "ts": now,
            "num_workers": self.num_workers,
            "telemetry": self.full,
            "per_rank": per_rank,
            "cluster": cluster,
        }
        if self.requests_total:
            cluster["requests_total"] = self.requests_total
        if self.slo is not None:
            out["slo"] = {
                name: {k: round(v, 3) for k, v in rates.items()}
                for name, rates in self.slo.burn_rates().items()
            }
        if self._elastic is not None:
            out["elastic"] = dict(self._elastic)
        profile = self._profile_summary()
        if profile:
            out["profile"] = profile
        gp = self.goodput_summary()
        if gp["total_s"] > 0:
            out["goodput"] = gp
        return out

    def _profile_summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self._profile_cost:
            out["cost"] = {
                program: {
                    k: v for k, v in rec.items() if k not in ("kind", "ts")
                }
                for program, rec in self._profile_cost.items()
            }
        if self._profile_captures:
            out["captures"] = [
                {k: v for k, v in rec.items() if k not in ("kind", "ts")}
                for _, rec in sorted(
                    self._profile_captures.items(), key=lambda kv: str(kv[0])
                )
            ]
        if self._profile_attr:
            out["attribution"] = {
                str(rank): {
                    k: v for k, v in rec.items() if k not in ("kind", "ts")
                }
                for rank, rec in self._profile_attr.items()
            }
        return out

    # ----------------------------------------------------------------- #
    # outputs
    # ----------------------------------------------------------------- #
    def _maybe_write_summary(self, now: float) -> None:
        if not self.full or now - self._summary_written < self._summary_interval:
            return
        self._summary_written = now
        self.registry.push_history(now)
        self._run_anomaly(now)
        self._write_json(SUMMARY_FILE, self.summary())

    def _run_anomaly(self, now: float) -> None:
        if self.anomaly is None:
            return
        gp = self.goodput_summary()
        fraction = gp["fraction"] if gp["total_s"] > 0 else None
        for ev in self.anomaly.evaluate(
            reg=self.registry,
            goodput_fraction=fraction,
            last_fault_ts=self._last_fault_ts,
            now=now,
        ):
            self.record_event(ev.pop("event"), **ev)

    def _write_json(self, filename: str, obj: Any) -> None:
        path = os.path.join(self.run_dir, filename)
        try:
            fsio.atomic_write_json(path, obj, default=str)
        except OSError:  # pragma: no cover
            pass

    def per_rank_histograms(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for (name, labels), m in self.registry.items():
            if isinstance(m, _metrics.Histogram):
                h = {
                    "bounds": list(m.bounds),
                    "counts": list(m.counts),
                    "sum": m.sum,
                    "count": m.count,
                }
                if m.exemplars:
                    # slow buckets name their offending request ids
                    h["exemplars"] = {
                        str(b): list(ids)
                        for b, ids in sorted(m.exemplars.items())
                    }
                out.setdefault(name, {})[_metrics._format_labels(labels) or "{}"] = h
        return out

    def finalize(
        self, driver_events: Optional[List[_trace.TraceTuple]] = None
    ) -> Optional[str]:
        """Write trace.json / metrics.json / metrics.prom (full mode) and
        close the flight record. Returns the run dir when outputs exist."""
        if self._finalized:
            return self.run_dir if self.full else None
        self._finalized = True
        if self._prom is not None:
            self._prom.stop()
            self._prom = None
        if self.full:
            events_by_rank: Dict[Any, List[_trace.TraceTuple]] = {
                r: list(buf) for r, buf in self._trace_by_rank.items()
            }
            if driver_events:
                events_by_rank[_trace.DRIVER] = list(driver_events)
            merged = _trace.merge_traces(events_by_rank, self.skew_by_rank())
            # cross-replica request lineage: stitch the fleet-wide
            # requests.jsonl into causal timelines (skew-corrected),
            # land lineage.jsonl next to it and thread Perfetto flow
            # arrows between the replica tracks in trace.json
            req_path = os.path.join(self.run_dir, REQUESTS_FILE)
            if os.path.exists(req_path) or os.path.exists(req_path + ".1"):
                lineages = _lineage.load_lineages(
                    req_path, self.skew_by_rank()
                )
                if lineages:
                    _lineage.write_lineage(
                        os.path.join(self.run_dir, _lineage.LINEAGE_FILE),
                        lineages,
                    )
                    merged["traceEvents"].extend(
                        _lineage.chrome_events(lineages)
                    )
            self._write_json(TRACE_FILE, merged)
            self._write_json(
                METRICS_FILE,
                {
                    "summary": self.summary(),
                    "per_rank_histograms": self.per_rank_histograms(),
                },
            )
            self._write_json(SUMMARY_FILE, self.summary())
            try:
                with open(os.path.join(self.run_dir, PROM_FILE), "w") as f:
                    f.write(self.registry.prometheus_text())
            except OSError:  # pragma: no cover
                pass
        self._events.close()
        if self._requests is not None:
            self._requests.close()
        return self.run_dir if self.full else None


def write_local_dump(
    run_dir: str,
    recorder: Optional[_trace.TraceRecorder],
    registry: Optional[_metrics.MetricsRegistry],
    rank: int = 0,
    requests: Optional[List[dict]] = None,
    profile: Optional[List[dict]] = None,
) -> str:
    """Dump a single process's telemetry (no launcher / in-process
    strategies): same file set as the driver aggregator, one rank track.
    ``requests`` carries finished-request records (an engine tracer's
    drain) into ``requests.jsonl``; ``profile`` carries drained profiler
    records (cost / capture / attribution)."""
    agg = DriverAggregator(run_dir, num_workers=1, full=True)
    payload: Dict[str, Any] = {}
    if registry is not None:
        payload["m"] = registry.snapshot(delta=False)
    if recorder is not None:
        payload["t"] = recorder.drain()
    if requests:
        payload["r"] = list(requests)
    if profile:
        payload["p"] = list(profile)
    if payload:
        agg.ingest_payload(rank, payload)
    agg.finalize()
    return run_dir


# --------------------------------------------------------------------- #
# `rlt top` style live summary
# --------------------------------------------------------------------- #
def format_summary(summary: Dict[str, Any], events: List[dict]) -> str:
    lines: List[str] = []
    cl = summary.get("cluster", {})
    age = time.time() - summary.get("ts", time.time())
    lines.append(
        f"rlt top — {summary.get('num_workers', '?')} worker(s), "
        f"summary age {age:.1f}s"
    )
    cl_bits = []
    for key, fmt in (
        ("step_time_p50", "step p50 {:.4f}s"),
        ("step_time_p90", "p90 {:.4f}s"),
        ("step_time_max_skew", "skew {:.4f}s"),
        ("samples_per_sec", "{:.1f} samples/s"),
        ("mfu", "MFU {:.3f}"),
        ("input_starved_s", "input starved {:.2f}s"),
        ("requests_total", "{:d} requests"),
    ):
        if key in cl:
            cl_bits.append(fmt.format(cl[key]))
    if "hbm_bytes_in_use" in cl:
        cl_bits.append(f"HBM {cl['hbm_bytes_in_use'] / 2**30:.2f}GB")
    if cl_bits:
        lines.append("cluster: " + " · ".join(cl_bits))
    slo_state = summary.get("slo")
    if slo_state:
        slo_bits = []
        for name, rates in sorted(slo_state.items()):
            mark = "BREACH" if rates.get("breached") else "ok"
            slo_bits.append(
                f"{name} {mark} (fast {rates.get('fast', 0):.1f}x "
                f"slow {rates.get('slow', 0):.1f}x)"
            )
        lines.append("slo: " + " · ".join(slo_bits))
    el = summary.get("elastic")
    if el:
        el_bits = [
            f"world {el.get('world_size', '?')}",
            f"epoch {el.get('membership_epoch', '?')}",
            f"shrinks {el.get('shrinks', 0)}",
            f"grows {el.get('grows', 0)}",
        ]
        if "last_recovery_s" in el:
            el_bits.append(f"last recovery {el['last_recovery_s']:.1f}s")
        lines.append("elastic: " + " · ".join(el_bits))
    header = f"{'rank':>5} {'step':>8} {'p50(s)':>9} {'p90(s)':>9} " \
             f"{'sps':>9} {'mfu':>7} {'starve(s)':>9} {'hbm(GB)':>8} " \
             f"{'beat age':>9} {'skew(s)':>9}"
    lines.append(header)
    for rank, info in sorted(summary.get("per_rank", {}).items(), key=lambda kv: kv[0]):
        def _f(key, spec, default="-"):
            v = info.get(key)
            return spec.format(v) if v is not None else default

        hbm = info.get("hbm_bytes_in_use")
        hbm_gb = f"{hbm / 2**30:.2f}" if hbm is not None else "-"
        lines.append(
            f"{rank:>5} {_f('step', '{:d}'):>8} "
            f"{_f('step_time_p50', '{:.4f}'):>9} "
            f"{_f('step_time_p90', '{:.4f}'):>9} "
            f"{_f('samples_per_sec', '{:.1f}'):>9} "
            f"{_f('mfu', '{:.3f}'):>7} "
            f"{_f('input_starved_s', '{:.2f}'):>9} "
            f"{hbm_gb:>8} "
            f"{_f('heartbeat_age_s', '{:.1f}'):>9} "
            f"{_f('clock_skew_s', '{:.4f}'):>9}"
        )
    if events:
        lines.append("recent events:")
        for ev in events[-5:]:
            ts = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0)))
            rest = {k: v for k, v in ev.items() if k not in ("ts", "event")}
            lines.append(f"  {ts} {ev.get('event', '?')} {rest if rest else ''}")
    return "\n".join(lines)


def _read_summary(run_dir: str) -> Optional[Dict[str, Any]]:
    for fname in (SUMMARY_FILE, METRICS_FILE):
        path = os.path.join(run_dir, fname)
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, ValueError):
            continue
        return obj.get("summary", obj) if fname == METRICS_FILE else obj
    return None


def _read_events(run_dir: str, limit: int = 32) -> List[dict]:
    path = os.path.join(run_dir, EVENTS_FILE)
    try:
        with open(path) as f:
            lines = f.readlines()[-limit:]
    except OSError:
        return []
    out = []
    for line in lines:
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


def start_prom_file_server(
    run_dir: str, port: int
) -> "_metrics.PromServer":
    """Serve ``<run_dir>/metrics.prom`` over HTTP so Prometheus can
    scrape a run from the driver box without the run itself opening a
    port (complement to the in-driver ``TORCHRT_PROM_PORT`` endpoint).
    Responds 503 while the file does not exist yet."""
    path = os.path.join(run_dir, PROM_FILE)

    def provider() -> str:
        with open(path, encoding="utf-8") as f:
            return f.read()

    srv = _metrics.PromServer(provider, port=port)
    srv.start()
    return srv


def render_top(
    run_dir: str,
    follow: bool = False,
    interval: float = 2.0,
    serve_port: Optional[int] = None,
    _print=print,
) -> int:
    """Render the live summary for ``run_dir``; with ``follow`` keep
    refreshing until interrupted. With ``serve_port`` also expose
    ``metrics.prom`` at ``http://127.0.0.1:<port>/metrics`` and stay
    alive (even without ``follow``) so the endpoint remains scrapable.
    Returns a process exit code."""
    srv = None
    if serve_port is not None:
        srv = start_prom_file_server(run_dir, serve_port)
        _print(
            f"serving metrics at http://127.0.0.1:{srv.port}/metrics "
            f"(from {os.path.join(run_dir, PROM_FILE)})"
        )
    try:
        while True:
            summary = _read_summary(run_dir)
            if summary is None:
                _print(f"no telemetry summary found under {run_dir} "
                       f"(is TORCHRT_TELEMETRY=1 set on the run?)")
                if not follow and srv is None:
                    return 1
            else:
                if follow:
                    _print("\x1b[2J\x1b[H", end="")
                _print(format_summary(summary, _read_events(run_dir)))
            if not follow and srv is None:
                return 0
            try:
                time.sleep(interval)
            except KeyboardInterrupt:  # pragma: no cover
                return 0
    finally:
        if srv is not None:
            srv.stop()
