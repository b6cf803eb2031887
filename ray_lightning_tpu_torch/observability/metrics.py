"""Process-local metrics registry: counters, gauges, histograms
(``ray_lightning_tpu/observability/metrics.py``).

Record paths are deliberately cheap — metric handles are looked up once
and cached by the call site (or fetched via :meth:`MetricsRegistry.counter`
etc., a dict get), after which ``inc``/``set``/``observe`` are a couple of
float ops. There is no background thread and no locking on the record
path; the GIL makes the individual mutations atomic enough for telemetry.

Serialization is snapshot-based: :meth:`MetricsRegistry.snapshot` returns
a plain-dict structure safe to ship over the heartbeat channel. Histograms
keep a bounded list of raw *pending* samples that is drained on each delta
snapshot, so the driver-side aggregator can rebuild true per-rank sample
distributions (percentiles, skew) instead of being stuck with bucket
resolution.
"""
from __future__ import annotations

import os
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]

# Tuned for step/IO latencies in seconds: 100 µs .. 60 s.
DEFAULT_BOUNDS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# Cap on raw samples buffered between two delta snapshots.
PENDING_CAP = 4096
# Last-N exemplar ids kept per histogram bucket.
EXEMPLAR_CAP = 3

# Ring-buffered registry history: how many compact snapshots the black-box
# recorder keeps (pushed on the driver's summary cadence, ~2s apart).
HISTORY_ENV = "TORCHRT_METRICS_HISTORY"
HISTORY_DEFAULT = 64

# Driver-local Prometheus scrape endpoint (unset = disabled, 0 = ephemeral).
PROM_PORT_ENV = "TORCHRT_PROM_PORT"


# Serving-resilience metric names, shared by serving/resilience.py, the
# engine's shed/expiry paths and the replica router, so that the emit
# sites agree on one spelling.
SERVE_RETRIES_METRIC = "rlt_serve_retries_total"
SERVE_SHED_METRIC = "rlt_serve_shed_total"
SERVE_DEADLINE_EXPIRED_METRIC = "rlt_serve_deadline_expired_total"
SERVE_BREAKER_STATE_METRIC = "rlt_serve_breaker_state"
SERVE_CAPACITY_BLOCKED_METRIC = "rlt_serve_capacity_blocked_total"

# Disaggregated-serving migration metrics (the fleet's KV-shipment pump
# in serving/replica.py is the single emit site).
SERVE_MIGRATION_ATTEMPTS_METRIC = "rlt_serve_migration_attempts_total"
SERVE_MIGRATION_VERIFIED_METRIC = "rlt_serve_migration_verified_total"
SERVE_MIGRATION_CORRUPT_METRIC = "rlt_serve_migration_corrupt_total"
SERVE_MIGRATION_RETRIES_METRIC = "rlt_serve_migration_retries_total"
SERVE_MIGRATION_FALLBACKS_METRIC = "rlt_serve_migration_fallbacks_total"
SERVE_MIGRATION_BYTES_METRIC = "rlt_serve_migration_bytes_total"
SERVE_MIGRATION_TRANSFER_MS_METRIC = "rlt_serve_migration_transfer_ms"

# Multi-tenant QoS metric names (serving/tenancy.py, the engine's
# per-tenant admission/finish paths, and the scheduler's per-tenant
# queue gauges are the emit sites). Every series carries a `tenant`
# label whose value passes through MetricsRegistry.tenant_label — the
# cardinality cap below — so a million-user tenant population cannot
# mint unbounded label values.
TENANT_REQUESTS_METRIC = "rlt_tenant_requests_total"
TENANT_COMPLETIONS_METRIC = "rlt_tenant_completions_total"
TENANT_QUOTA_REJECTED_METRIC = "rlt_tenant_quota_rejected_total"
TENANT_SHED_METRIC = "rlt_tenant_shed_total"
TENANT_QUEUE_DEPTH_METRIC = "rlt_tenant_queue_depth"
TENANT_TTFT_METRIC = "rlt_tenant_ttft_seconds"

# Cross-replica request lineage: per-component TTFT decomposition
# (observability/reqtrace.py is the single emit site, on the hop that
# delivers the first token). Components telescope across hops — their
# sum per request equals the measured end-to-end TTFT.
SERVE_TTFT_COMPONENT_METRIC = "rlt_serve_ttft_component_seconds"
# Same shape as the serving latency histograms: sub-millisecond buckets
# at the fast end (tiny-model queue/transfer segments), tens of seconds
# at the slow end.
TTFT_COMPONENT_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def history_cap() -> int:
    try:
        return max(0, int(os.environ.get(HISTORY_ENV, HISTORY_DEFAULT)))
    except ValueError:
        return HISTORY_DEFAULT


# Per-tenant label cardinality cap: at most this many DISTINCT tenant
# label values per registry; later tenants collapse into the overflow
# bucket so the exposition stays bounded no matter how many tenant
# names traffic carries.
TENANT_CARDINALITY_ENV = "TORCHRT_METRIC_TENANT_CARDINALITY"
TENANT_CARDINALITY_DEFAULT = 32
TENANT_OVERFLOW_LABEL = "__overflow__"


def tenant_cardinality_cap() -> int:
    try:
        return max(
            1,
            int(
                os.environ.get(
                    TENANT_CARDINALITY_ENV, TENANT_CARDINALITY_DEFAULT
                )
            ),
        )
    except ValueError:
        return TENANT_CARDINALITY_DEFAULT


# `# HELP` text for the exposition; metrics not listed fall back to a
# name-derived placeholder so every family still carries a HELP line.
HELP: Dict[str, str] = {
    "rlt_step_time_seconds": "Training step wall time per rank.",
    "rlt_heartbeat_latency_seconds": "Heartbeat send-to-receive latency.",
    "rlt_heartbeat_age_seconds": "Seconds since the last beat per rank.",
    "rlt_worker_step": "Latest step number reported by each rank.",
    "rlt_serve_ttft_seconds": "Serving time-to-first-token (submit to first sampled token).",
    "rlt_serve_itl_seconds": "Serving inter-token latency.",
    "rlt_serve_queue_depth": "Serving admission queue depth.",
    "rlt_slo_burn_rate": "SLO error-budget burn rate per objective and window.",
    "rlt_slo_breached": "1 while the objective's multi-window burn-rate alert is firing.",
    "rlt_hbm_bytes_in_use": "Device (HBM) bytes currently allocated, per local device.",
    "rlt_hbm_peak_bytes": "Peak device (HBM) bytes allocated, per local device.",
    "rlt_serve_retries_total": "Journaled serving requests resubmitted after replica failure.",
    "rlt_serve_shed_total": "Serving requests rejected by the load-shed policy.",
    "rlt_serve_deadline_expired_total": "Serving requests evicted past their deadline (queued or decoding).",
    "rlt_serve_breaker_state": "Replica circuit-breaker state (0 closed, 1 half-open, 2 open).",
    "rlt_serve_migration_attempts_total": "KV-shipment migration attempts (prefill pool to decode pool).",
    "rlt_serve_migration_verified_total": "KV shipments that passed checksum/fingerprint verification and were admitted.",
    "rlt_serve_migration_corrupt_total": "KV shipments rejected by receiver-side checksum verification (never decoded).",
    "rlt_serve_migration_retries_total": "Migration attempts retried after a failed send/verify/admit step.",
    "rlt_serve_migration_fallbacks_total": "Migrations abandoned to colocated decode on the prefill replica.",
    "rlt_serve_migration_bytes_total": "KV payload bytes shipped by admitted migrations.",
    "rlt_serve_migration_transfer_ms": "End-to-end migration transfer time (export to admitted), milliseconds.",
    "rlt_serve_ttft_component_seconds": "TTFT decomposition per lineage component and pool (components sum to measured TTFT).",
    "rlt_goodput_seconds_total": "Wall time per goodput category (category, src labels).",
    "rlt_goodput_fraction": "Fraction of fleet wall time spent in productive compute.",
    "rlt_anomaly_score": "Current robust z-score (or drop) per anomaly detector.",
    "rlt_anomaly_events_total": "Anomaly detector firings per detector.",
    "rlt_incidents_captured_total": "Incident bundles written per triggering kind.",
    "rlt_incidents_suppressed_total": "Incident captures suppressed by the per-kind cooldown.",
    "rlt_bench_probe_failures_total": "Native bench backend probes that failed or timed out.",
    "rlt_tenant_requests_total": "Serving requests accepted per tenant (post quota/shed admission).",
    "rlt_tenant_completions_total": "Serving completions per tenant and finish reason.",
    "rlt_tenant_quota_rejected_total": "Requests refused by the tenant's token-bucket quota (distinct from shed).",
    "rlt_tenant_shed_total": "Requests shed by the load-shed policy, per tenant.",
    "rlt_tenant_queue_depth": "Per-tenant admission queue depth (DRR queues; tenancy configured only).",
    "rlt_tenant_ttft_seconds": "Serving time-to-first-token per tenant.",
}


def set_help(name: str, text: str) -> None:
    """Register `# HELP` text for a metric family."""
    HELP[name] = text


def help_for(name: str) -> str:
    return HELP.get(name, name.replace("_", " "))


def _key(name: str, labels: Dict[str, Any]) -> LabelKey:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    # Prometheus text format: backslash, double-quote, and newline must be
    # escaped inside label values for real scrapers to parse the output.
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _format_labels(labels: Sequence[Tuple[str, str]], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    __slots__ = ("value",)

    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    __slots__ = ("value",)

    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Histogram:
    """Fixed-bucket histogram plus a bounded buffer of raw samples.

    ``counts``/``sum``/``count`` are cumulative (Prometheus semantics,
    with a +Inf overflow bucket at the end). ``pending`` holds samples
    recorded since the last delta snapshot, hard-capped at
    ``pending_cap`` entries so a stalled drain can't grow memory;
    ``recent`` is a ring used for local percentile queries.
    ``exemplars`` keeps the last few observation ids (e.g. request ids)
    per bucket so a slow bucket names its offenders.
    """

    __slots__ = (
        "bounds", "counts", "sum", "count", "pending", "pending_cap",
        "recent", "exemplars",
    )

    kind = "histogram"

    def __init__(
        self,
        bounds: Sequence[float] = DEFAULT_BOUNDS,
        pending_cap: int = PENDING_CAP,
    ):
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.pending: List[float] = []
        self.pending_cap = max(1, int(pending_cap))
        self.recent: deque = deque(maxlen=1024)
        self.exemplars: Dict[int, List[str]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        value = float(value)
        bucket = bisect_left(self.bounds, value)
        self.counts[bucket] += 1
        self.sum += value
        self.count += 1
        if len(self.pending) < self.pending_cap:
            self.pending.append(value)
        self.recent.append(value)
        if exemplar is not None:
            ids = self.exemplars.setdefault(bucket, [])
            ids.append(str(exemplar))
            if len(ids) > EXEMPLAR_CAP:
                del ids[0]

    def bucket_exemplars(self, lower_than: Optional[float] = None) -> List[str]:
        """Exemplar ids, slowest buckets first; with ``lower_than`` only
        buckets whose lower bound is >= that value (``ttft > 1s`` style)."""
        out: List[str] = []
        for bucket in sorted(self.exemplars, reverse=True):
            lower = self.bounds[bucket - 1] if bucket > 0 else 0.0
            if lower_than is not None and lower < lower_than:
                continue
            out.extend(reversed(self.exemplars[bucket]))
        return out

    def load(self, counts: Sequence[int], total: float, count: int) -> None:
        """Overwrite cumulative state (driver rebuilding a worker histogram)."""
        if len(counts) == len(self.counts):
            self.counts = list(counts)
        self.sum = float(total)
        self.count = int(count)

    def percentile(self, q: float) -> Optional[float]:
        if not self.recent:
            return None
        return percentile(list(self.recent), q)

    def drain_pending(self) -> List[float]:
        out, self.pending = self.pending, []
        return out


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an unsorted sample list; q in [0, 100]."""
    s = sorted(samples)
    if not s:
        raise ValueError("percentile of empty sample list")
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


class MetricsRegistry:
    """Keyed (name, labels) metric store with snapshot/delta serialization."""

    def __init__(self):
        self._metrics: Dict[LabelKey, Any] = {}
        # black-box ring: compact timestamped snapshots, pushed on the
        # driver's summary cadence; incident bundles dump the window
        self._history: deque = deque(maxlen=history_cap() or 1)
        self._history_enabled = history_cap() > 0
        # distinct tenant label values admitted so far (cardinality cap)
        self._tenant_labels: set = set()

    def tenant_label(self, tenant: str) -> str:
        """Cardinality-capped tenant label value: the first
        ``TORCHRT_METRIC_TENANT_CARDINALITY`` distinct tenants keep their
        name; every later tenant collapses into the shared
        ``__overflow__`` series (aggregate visibility without unbounded
        label growth)."""
        tenant = str(tenant)
        if tenant in self._tenant_labels:
            return tenant
        if len(self._tenant_labels) < tenant_cardinality_cap():
            self._tenant_labels.add(tenant)
            return tenant
        return TENANT_OVERFLOW_LABEL

    def __len__(self) -> int:
        return len(self._metrics)

    def _get(self, cls, name: str, labels: Dict[str, Any], **kwargs):
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(**kwargs)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self, name: str, bounds: Sequence[float] = DEFAULT_BOUNDS, **labels
    ) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def get(self, name: str, **labels):
        return self._metrics.get(_key(name, labels))

    def items(self):
        return self._metrics.items()

    def drop_series(self, **labels) -> int:
        """Remove every series whose label set contains all given pairs
        (e.g. ``drop_series(rank=3)`` after an elastic shrink evicts a
        rank, so summaries/Prometheus stop reporting the dead worker).
        Returns the number of series removed."""
        match = {(k, str(v)) for k, v in labels.items()}
        doomed = [key for key in self._metrics if match <= set(key[1])]
        for key in doomed:
            del self._metrics[key]
        return len(doomed)

    # ----------------------------------------------------------------- #
    # serialization
    # ----------------------------------------------------------------- #
    def snapshot(self, delta: bool = False) -> Dict[str, Any]:
        """Plain-dict snapshot: counters/gauges are cumulative values;
        histograms carry cumulative buckets plus raw samples. With
        ``delta=True`` the histogram sample buffers are drained, so a
        sequence of delta snapshots partitions the sample stream."""
        counters: List[Any] = []
        gauges: List[Any] = []
        hists: List[Any] = []
        for (name, labels), m in self._metrics.items():
            if isinstance(m, Counter):
                counters.append([name, list(labels), m.value])
            elif isinstance(m, Gauge):
                gauges.append([name, list(labels), m.value])
            else:
                samples = m.drain_pending() if delta else list(m.recent)
                h: Dict[str, Any] = {
                    "bounds": list(m.bounds),
                    "counts": list(m.counts),
                    "sum": m.sum,
                    "count": m.count,
                    "samples": samples,
                }
                if m.exemplars:
                    # str keys so the dict survives a JSON round-trip
                    h["exemplars"] = {
                        str(b): list(ids) for b, ids in m.exemplars.items()
                    }
                hists.append([name, list(labels), h])
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def is_empty_snapshot(self, snap: Dict[str, Any]) -> bool:
        return not (snap["counters"] or snap["gauges"] or snap["histograms"])

    def merge_snapshot(
        self, snap: Dict[str, Any], extra_labels: Optional[Dict[str, Any]] = None
    ) -> None:
        """Fold a (worker) snapshot into this registry, optionally adding
        labels (the driver adds ``rank=N``). Counter/gauge values and
        histogram cumulative state are overwritten (they are cumulative at
        the source); histogram samples are appended to the local buffers."""
        extra = extra_labels or {}

        def _merged(labels):
            d = dict(labels)
            d.update(extra)
            return d

        for name, labels, value in snap.get("counters", ()):
            self.counter(name, **_merged(labels)).value = value
        for name, labels, value in snap.get("gauges", ()):
            self.gauge(name, **_merged(labels)).set(value)
        for name, labels, h in snap.get("histograms", ()):
            m = self.histogram(name, bounds=h["bounds"], **_merged(labels))
            m.load(h["counts"], h["sum"], h["count"])
            for v in h.get("samples", ()):
                if len(m.pending) < m.pending_cap:
                    m.pending.append(v)
                m.recent.append(v)
            for b, ids in (h.get("exemplars") or {}).items():
                dst = m.exemplars.setdefault(int(b), [])
                for x in ids:
                    dst.append(str(x))
                del dst[:-EXEMPLAR_CAP]

    # ----------------------------------------------------------------- #
    # history ring (black-box recorder)
    # ----------------------------------------------------------------- #
    def push_history(self, now: Optional[float] = None) -> None:
        """Append one compact snapshot to the bounded history ring.
        Histograms are summarized (sum/count/p50/p99 over the recent
        window) instead of carrying buckets + raw samples, so N entries
        stay cheap enough to hold in memory and dump into a bundle."""
        if not self._history_enabled:
            return
        counters: List[Any] = []
        gauges: List[Any] = []
        hists: List[Any] = []
        for (name, labels), m in self._metrics.items():
            if isinstance(m, Counter):
                counters.append([name, list(labels), m.value])
            elif isinstance(m, Gauge):
                gauges.append([name, list(labels), m.value])
            else:
                recent = list(m.recent)
                hists.append([
                    name,
                    list(labels),
                    {
                        "sum": m.sum,
                        "count": m.count,
                        "p50": percentile(recent, 50) if recent else None,
                        "p99": percentile(recent, 99) if recent else None,
                    },
                ])
        self._history.append({
            "ts": time.time() if now is None else now,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        })

    def history(self, since: Optional[float] = None) -> List[Dict[str, Any]]:
        """Snapshots in the ring, oldest first; ``since`` filters by ts."""
        entries = list(self._history)
        if since is not None:
            entries = [e for e in entries if e["ts"] >= since]
        return entries

    # ----------------------------------------------------------------- #
    # exposition
    # ----------------------------------------------------------------- #
    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one line per series), with
        `# HELP`/`# TYPE` headers per family and escaped label values."""
        lines: List[str] = []
        seen_type: Dict[str, str] = {}
        for (name, labels), m in sorted(self._metrics.items()):
            if seen_type.get(name) != m.kind:
                lines.append(f"# HELP {name} {_escape_help(help_for(name))}")
                lines.append(f"# TYPE {name} {m.kind}")
                seen_type[name] = m.kind
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{name}{_format_labels(labels)} {_num(m.value)}")
            else:
                cum = 0
                for bound, c in zip(m.bounds, m.counts):
                    cum += c
                    le = _format_labels(labels, f'le="{_num(bound)}"')
                    lines.append(f"{name}_bucket{le} {cum}")
                cum += m.counts[-1]
                le = _format_labels(labels, 'le="+Inf"')
                lines.append(f"{name}_bucket{le} {cum}")
                lines.append(f"{name}_sum{_format_labels(labels)} {_num(m.sum)}")
                lines.append(f"{name}_count{_format_labels(labels)} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def reset_registry() -> MetricsRegistry:
    """Replace the global registry (test isolation)."""
    global _registry
    _registry = MetricsRegistry()
    _devmem_cache[0] = 0.0
    _devmem_cache[1] = None
    return _registry


# --------------------------------------------------------------------- #
# device-memory telemetry (HBM gauges)
# --------------------------------------------------------------------- #
HBM_IN_USE_METRIC = "rlt_hbm_bytes_in_use"
HBM_PEAK_METRIC = "rlt_hbm_peak_bytes"
DEVMEM_MIN_INTERVAL_S = 5.0

# [last monotonic sample time, last stats list or None]
_devmem_cache: List[Any] = [0.0, None]


def device_memory_stats() -> List[Dict[str, Any]]:
    """Allocator statistics of this process's current CUDA device, as
    ``[{"device": "cuda:<i>", "bytes_in_use", "peak_bytes",
    "bytes_limit"}]``: ``allocated_bytes.all.current``/``.peak`` of
    ``torch.cuda.memory_stats`` and the card's total memory.

    Returns ``[]`` unless this process has already initialised CUDA: a
    driver or a CPU worker must never open a context here (a context
    costs memory on the card and breaks the zygote's fork). Callers treat
    device-memory telemetry as optional.
    """
    try:
        import torch

        if not torch.cuda.is_initialized():
            return []
        dev = torch.cuda.current_device()
        stats = torch.cuda.memory_stats(dev)
        limit = int(torch.cuda.mem_get_info(dev)[1])
    except Exception:
        return []
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    return [{
        "device": f"cuda:{dev}",
        "bytes_in_use": in_use,
        "peak_bytes": int(stats.get("allocated_bytes.all.peak", in_use)),
        "bytes_limit": limit,
    }]


def publish_device_memory(
    reg: Optional[MetricsRegistry],
    min_interval_s: float = DEVMEM_MIN_INTERVAL_S,
    force: bool = False,
) -> List[Dict[str, Any]]:
    """Throttled device-memory snapshot into the HBM gauges.

    Samples at most once per ``min_interval_s`` (cached list returned in
    between — a beat-rate call site costs one clock read). Publishes
    ``rlt_hbm_bytes_in_use`` / ``rlt_hbm_peak_bytes`` per device when a
    registry is given.
    """
    now = time.monotonic()
    if (
        not force
        and _devmem_cache[1] is not None
        and now - _devmem_cache[0] < min_interval_s
    ):
        return _devmem_cache[1]
    stats = device_memory_stats()
    _devmem_cache[0] = now
    _devmem_cache[1] = stats
    if reg is not None:
        for s in stats:
            reg.gauge(HBM_IN_USE_METRIC, device=s["device"]).set(s["bytes_in_use"])
            reg.gauge(HBM_PEAK_METRIC, device=s["device"]).set(s["peak_bytes"])
    return stats


def last_device_memory() -> Optional[List[Dict[str, Any]]]:
    """The most recent (possibly stale) device-memory snapshot, or None
    if none has been taken — never touches the device."""
    return _devmem_cache[1]


# --------------------------------------------------------------------- #
# Prometheus scrape endpoint
# --------------------------------------------------------------------- #
class PromServer:
    """Tiny stdlib HTTP server exposing a text provider at ``/metrics``
    (and ``/``), so the live registry is scrapeable instead of being
    file-dump-only. Daemon-threaded; ``stop()`` is idempotent."""

    def __init__(
        self,
        provider: Callable[[], str],
        port: int = 0,
        host: str = "127.0.0.1",
    ) -> None:
        self._provider = provider
        self._host = host
        self._requested_port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def start(self) -> int:
        import http.server

        provider = self._provider

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API
                if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = provider().encode("utf-8")
                except Exception as e:  # provider failure -> scrape error
                    self.send_error(503, explain=str(e))
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (self._host, self._requested_port), _Handler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="rlt-prom",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def prom_port_from_env() -> Optional[int]:
    """The TORCHRT_PROM_PORT knob: an int port (0 = ephemeral) or None when
    unset/invalid — callers treat None as 'endpoint disabled'."""
    raw = os.environ.get(PROM_PORT_ENV)
    if raw is None or not raw.strip():
        return None
    try:
        return int(raw)
    except ValueError:
        return None
