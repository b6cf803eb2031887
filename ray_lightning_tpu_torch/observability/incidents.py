"""Black-box incident recorder
(``ray_lightning_tpu/observability/incidents.py``).

When a fault verdict, SLO breach, transfer failure, or anomaly event
fires, the evidence is scattered: ``events.jsonl`` keeps rotating,
metric snapshots are delta-based and have already moved on, and the
ledgers (arbiter / membership / request journal) only say what is true
*now*. The :class:`IncidentRecorder` freezes all of it at the moment the
event fires into one self-contained bundle under
``<telemetry>/incidents/<ts>_<kind>/``:

- ``incident.json`` — the triggering event plus capture metadata,
- ``events.jsonl`` — the trailing flight-record window, stitched across
  the writer's rotation boundary (:func:`.reqtrace.read_window`),
- ``metrics_history.json`` — the registry's ring-buffered snapshot
  history (:meth:`.metrics.MetricsRegistry.history`),
- ``trace_slice.json`` — a merged Chrome-trace slice of the recent
  per-rank trace tails,
- ``<source>.json`` — one file per registered snapshot source (arbiter
  ledger, membership ledger, request-journal summary, ...),
- optional extra text attachments (e.g. a bench probe's log tail).

Bundles are deduplicated per kind with a cooldown (``TORCHRT_INCIDENT_COOLDOWN_S``)
and the directory is pruned oldest-first past ``TORCHRT_INCIDENT_MAX_BUNDLES``,
so a crash loop cannot fill the disk with identical evidence.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

from . import reqtrace as _reqtrace

INCIDENTS_DIRNAME = "incidents"

MAX_BUNDLES_ENV = "TORCHRT_INCIDENT_MAX_BUNDLES"
MAX_BUNDLES_DEFAULT = 16
COOLDOWN_ENV = "TORCHRT_INCIDENT_COOLDOWN_S"
COOLDOWN_DEFAULT = 60.0
# Probe-failure bundles dedup CROSS-RUN (the in-memory per-kind cooldown
# above cannot: record_probe_failure builds a fresh recorder per bench
# invocation, so every rerun of a persistently-broken native probe used
# to mint a new bundle until the cap pruned real incidents). The newest
# existing bench_probe_failed bundle's directory timestamp gates the
# next one instead.
PROBE_COOLDOWN_ENV = "TORCHRT_PROBE_INCIDENT_COOLDOWN_S"
PROBE_COOLDOWN_DEFAULT = 3600.0
# Trailing flight-record bytes frozen into each bundle.
EVENT_WINDOW_BYTES = 256 * 1024

INCIDENTS_CAPTURED_METRIC = "rlt_incidents_captured_total"
INCIDENTS_SUPPRESSED_METRIC = "rlt_incidents_suppressed_total"
BENCH_PROBE_FAILURES_METRIC = "rlt_bench_probe_failures_total"

# Flight-record event kinds that trip a capture. Fault verdicts and the
# crash/relaunch path come from the supervisor/launcher; slo_breach from
# the SLO monitor; arbiter_rollback from failed chip transfers; the
# anomaly_* kinds from observability.anomaly; bench_probe_failed from the
# bench orchestrator.
INCIDENT_EVENT_KINDS = frozenset({
    "crash",
    "hang",
    "straggler",
    "slo_breach",
    "arbiter_rollback",
    "elastic_grow_failed",
    "bench_probe_failed",
    "anomaly_step_time",
    "anomaly_itl_p99",
    "anomaly_straggler",
    "anomaly_silent_goodput",
})

_BUNDLE_RE = re.compile(r"^(\d+)_(.+)$")


def max_bundles() -> int:
    try:
        return max(1, int(os.environ.get(MAX_BUNDLES_ENV, MAX_BUNDLES_DEFAULT)))
    except ValueError:
        return MAX_BUNDLES_DEFAULT


def cooldown_s() -> float:
    try:
        return max(0.0, float(os.environ.get(COOLDOWN_ENV, COOLDOWN_DEFAULT)))
    except ValueError:
        return COOLDOWN_DEFAULT


def probe_cooldown_s() -> float:
    try:
        return max(0.0, float(
            os.environ.get(PROBE_COOLDOWN_ENV, PROBE_COOLDOWN_DEFAULT)
        ))
    except ValueError:
        return PROBE_COOLDOWN_DEFAULT


def _slug(kind: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", str(kind)) or "event"


class IncidentRecorder:
    """Rate-limited, deduplicated incident-bundle writer for one run dir."""

    def __init__(
        self,
        run_dir: str,
        registry: Optional[Any] = None,
        events_path: Optional[str] = None,
        trace_provider: Optional[Callable[[], Any]] = None,
        clock: Callable[[], float] = time.time,
        cooldown: Optional[float] = None,
        bundle_cap: Optional[int] = None,
    ) -> None:
        self.run_dir = run_dir
        self.registry = registry
        self.events_path = events_path
        self.trace_provider = trace_provider
        self._clock = clock
        self._cooldown = cooldown_s() if cooldown is None else float(cooldown)
        self._cap = max_bundles() if bundle_cap is None else int(bundle_cap)
        self._sources: Dict[str, Callable[[], Any]] = {}
        self._last_capture: Dict[str, float] = {}

    @property
    def dir(self) -> str:
        return os.path.join(self.run_dir, INCIDENTS_DIRNAME)

    def register_source(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a snapshot source (e.g. ``arbiter_ledger``) whose
        return value is frozen into every future bundle as
        ``<name>.json``. Last registration per name wins."""
        self._sources[str(name)] = fn

    def maybe_capture(
        self,
        kind: str,
        event: Optional[Dict[str, Any]] = None,
        attachments: Optional[Dict[str, str]] = None,
    ) -> Optional[str]:
        """Capture a bundle for ``kind`` unless one was captured within
        the cooldown window. Returns the bundle path, or None when
        suppressed (or when writing failed — capture must never take the
        run down)."""
        now = self._clock()
        last = self._last_capture.get(kind)
        if last is not None and now - last < self._cooldown:
            if self.registry is not None:
                self.registry.counter(
                    INCIDENTS_SUPPRESSED_METRIC, kind=_slug(kind)
                ).inc()
            return None
        self._last_capture[kind] = now
        try:
            path = self._capture(kind, now, event, attachments)
        except OSError:
            return None
        if self.registry is not None:
            self.registry.counter(
                INCIDENTS_CAPTURED_METRIC, kind=_slug(kind)
            ).inc()
        self._prune()
        return path

    # -- internals -------------------------------------------------------

    def _capture(
        self,
        kind: str,
        now: float,
        event: Optional[Dict[str, Any]],
        attachments: Optional[Dict[str, str]],
    ) -> str:
        name = f"{int(now)}_{_slug(kind)}"
        path = os.path.join(self.dir, name)
        n = 1
        while os.path.exists(path):
            path = os.path.join(self.dir, f"{name}.{n}")
            n += 1
        os.makedirs(path, exist_ok=True)

        sources_written: List[str] = []
        for src_name, fn in sorted(self._sources.items()):
            try:
                obj = fn()
            except Exception as e:
                obj = {"error": f"{type(e).__name__}: {e}"}
            self._dump_json(path, f"{src_name}.json", obj)
            sources_written.append(src_name)

        if self.events_path:
            lines = _reqtrace.read_window(self.events_path, EVENT_WINDOW_BYTES)
            self._dump_text(path, "events.jsonl", "\n".join(lines) + "\n" if lines else "")

        if self.registry is not None:
            self._dump_json(path, "metrics_history.json", self.registry.history())

        if self.trace_provider is not None:
            try:
                trace_slice = self.trace_provider()
            except Exception as e:
                trace_slice = {"error": f"{type(e).__name__}: {e}"}
            self._dump_json(path, "trace_slice.json", trace_slice)

        for fname, content in (attachments or {}).items():
            self._dump_text(path, fname, content)

        self._dump_json(path, "incident.json", {
            "ts": now,
            "kind": kind,
            "event": event or {},
            "cooldown_s": self._cooldown,
            "sources": sources_written,
            "attachments": sorted((attachments or {}).keys()),
        })
        return path

    @staticmethod
    def _dump_json(bundle: str, fname: str, obj: Any) -> None:
        try:
            with open(os.path.join(bundle, fname), "w") as f:
                json.dump(obj, f, default=str, indent=1)
        except (OSError, TypeError, ValueError):
            pass

    @staticmethod
    def _dump_text(bundle: str, fname: str, content: str) -> None:
        try:
            with open(os.path.join(bundle, fname), "w", encoding="utf-8") as f:
                f.write(content)
        except OSError:
            pass

    def _prune(self) -> None:
        bundles = list_bundles(self.run_dir)
        excess = len(bundles) - self._cap
        for b in bundles[:max(0, excess)]:  # oldest first
            shutil.rmtree(b["path"], ignore_errors=True)


def list_bundles(run_dir: str) -> List[Dict[str, Any]]:
    """Incident bundles under ``run_dir``, oldest first."""
    root = os.path.join(run_dir, INCIDENTS_DIRNAME)
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        m = _BUNDLE_RE.match(name)
        info: Dict[str, Any] = {
            "name": name,
            "path": path,
            "ts": int(m.group(1)) if m else None,
            "kind": m.group(2).split(".", 1)[0] if m else name,
        }
        try:
            info["files"] = sorted(os.listdir(path))
        except OSError:
            info["files"] = []
        out.append(info)
    out.sort(key=lambda b: (b["ts"] or 0, b["name"]))
    return out


def load_bundle(path: str) -> Dict[str, Any]:
    """Load one bundle's ``incident.json`` plus per-file summaries (line
    counts for jsonl, top-level keys for json) for CLI rendering."""
    out: Dict[str, Any] = {"path": path, "files": {}}
    try:
        with open(os.path.join(path, "incident.json")) as f:
            out["incident"] = json.load(f)
    except (OSError, ValueError):
        out["incident"] = {}
    try:
        names = sorted(os.listdir(path))
    except OSError:
        names = []
    for name in names:
        p = os.path.join(path, name)
        try:
            if name.endswith(".jsonl"):
                with open(p, encoding="utf-8") as f:
                    out["files"][name] = {
                        "lines": sum(1 for ln in f if ln.strip())
                    }
            elif name.endswith(".json"):
                with open(p) as f:
                    obj = json.load(f)
                out["files"][name] = {
                    "keys": sorted(obj.keys()) if isinstance(obj, dict)
                    else f"list[{len(obj)}]" if isinstance(obj, list) else type(obj).__name__
                }
            else:
                out["files"][name] = {"bytes": os.path.getsize(p)}
        except (OSError, ValueError):
            out["files"][name] = {"error": "unreadable"}
    return out


def record_probe_failure(
    run_dir: str, error: str, log_tail: str = ""
) -> Optional[str]:
    """Bench satellite: land a ``bench_probe_failed`` event in the flight
    record, bump ``rlt_bench_probe_failures_total``, and capture an
    incident bundle carrying the probe's log tail — so a timed-out native
    probe is a first-class incident instead of a buried ``detail.error``
    string. Standalone (no aggregator required): appends to the run
    dir's ``events.jsonl`` directly."""
    from . import aggregator as _aggregator  # late: avoids import cycle

    try:
        os.makedirs(run_dir, exist_ok=True)
    except OSError:
        return None
    events_path = os.path.join(run_dir, _aggregator.EVENTS_FILE)
    event = {"ts": time.time(), "event": "bench_probe_failed", "error": str(error)}
    writer = _reqtrace.JsonlWriter(events_path)
    try:
        writer.write(event)
    finally:
        writer.close()
    reg = _metrics_registry()
    reg.counter(BENCH_PROBE_FAILURES_METRIC).inc()
    # cross-run dedup: each bench invocation builds a fresh recorder, so
    # the recorder's in-memory cooldown can never see a PREVIOUS run's
    # bundle — gate on the newest on-disk bench_probe_failed bundle
    # instead (its dirname timestamp is the capture time). The flight-
    # record event and the failure counter above always land; only the
    # duplicate bundle is suppressed.
    window = probe_cooldown_s()
    if window > 0:
        newest = max(
            (b["ts"] or 0 for b in list_bundles(run_dir)
             if b["kind"] == "bench_probe_failed"),
            default=None,
        )
        if newest is not None and time.time() - newest < window:
            reg.counter(
                INCIDENTS_SUPPRESSED_METRIC, kind="bench_probe_failed"
            ).inc()
            return None
    rec = IncidentRecorder(run_dir, registry=reg, events_path=events_path)
    return rec.maybe_capture(
        "bench_probe_failed",
        event=event,
        attachments={"probe_log.txt": log_tail or "(no probe output captured)\n"},
    )


def _metrics_registry():
    from . import metrics as _metrics

    return _metrics.get_registry()
