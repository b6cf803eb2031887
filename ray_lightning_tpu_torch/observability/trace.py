"""Lightweight distributed flight recorder: spans and events
(``ray_lightning_tpu/observability/trace.py``).

Every process (driver and each worker rank) owns at most one
:class:`TraceRecorder` — a bounded ring buffer of ``(kind, name,
wall_start, duration, step, args)`` tuples. Recording is designed around
two cost regimes:

- **disabled** (the default): ``span()`` returns a module-level no-op
  singleton and ``event()`` is a single ``None`` check — no allocation,
  no syscall, nothing on the hot path.
- **enabled** (``TORCHRT_TELEMETRY=1`` or a strategy ``telemetry=True`` knob):
  one ``time.time()`` + ``time.perf_counter()`` pair per span and one
  deque append; the ring drops the oldest events instead of growing.

Workers drain their ring into heartbeat payloads (see ``session.py``);
the driver-side aggregator merges all rings into a single Chrome/Perfetto
``trace.json`` (:func:`merge_traces`), correcting each rank's wall clock
by the skew estimated from heartbeat send/receive timestamps
(:func:`estimate_skew`).
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# one recorded unit: (kind, name, wall_start_s, duration_s, step, args)
#   kind "X" = complete span, "i" = instant event
TraceTuple = Tuple[str, str, float, float, Optional[int], Optional[dict]]

DEFAULT_RING = 4096
RING_ENV = "TORCHRT_TELEMETRY_RING"
ENABLE_ENV = "TORCHRT_TELEMETRY"

# rank label used for the driver process's track in the merged trace
DRIVER = "driver"

# reserved span/event arg: events carrying it are routed onto a named
# sub-track (Chrome "thread") of their rank's process instead of tid 0 —
# this is how per-request serving timelines get their own Perfetto track
TRACK_ARG = "track"


def env_enabled(environ=os.environ) -> bool:
    return str(environ.get(ENABLE_ENV, "")).strip().lower() in (
        "1", "true", "yes", "on",
    )


class TraceRecorder:
    """Bounded ring of trace tuples. Append is lock-free (deque is
    atomic under the GIL); :meth:`drain` pops destructively so concurrent
    appends during a drain are never lost, only deferred to the next one."""

    __slots__ = ("_ring",)

    def __init__(self, capacity: int = DEFAULT_RING):
        self._ring: deque = deque(maxlen=max(16, int(capacity)))

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def add_span(
        self,
        name: str,
        wall_start: float,
        duration: float,
        step: Optional[int] = None,
        args: Optional[dict] = None,
    ) -> None:
        self._ring.append(("X", name, wall_start, duration, step, args))

    def add_event(
        self, name: str, step: Optional[int] = None, args: Optional[dict] = None
    ) -> None:
        self._ring.append(("i", name, time.time(), 0.0, step, args))

    def drain(self) -> List[TraceTuple]:
        out: List[TraceTuple] = []
        ring = self._ring
        while True:
            try:
                out.append(ring.popleft())
            except IndexError:
                return out

    def peek(self, limit: int = 0) -> List[TraceTuple]:
        """Non-destructive copy of the last ``limit`` tuples (all when 0)
        — incident bundles snapshot the ring without stealing events from
        the eventual trace drain."""
        out = list(self._ring)
        return out[-limit:] if limit > 0 else out


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_rec", "_name", "_step", "_args", "_wall", "_t0")

    def __init__(self, rec: TraceRecorder, name: str, step, args):
        self._rec = rec
        self._name = name
        self._step = step
        self._args = args

    def __enter__(self) -> "_Span":
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._rec.add_span(
            self._name,
            self._wall,
            time.perf_counter() - self._t0,
            self._step,
            self._args,
        )
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()

_recorder: Optional[TraceRecorder] = None


def enable(capacity: Optional[int] = None) -> TraceRecorder:
    """Idempotently turn the recorder on (process-local)."""
    global _recorder
    if _recorder is None:
        if capacity is None:
            try:
                capacity = int(os.environ.get(RING_ENV, DEFAULT_RING))
            except ValueError:
                capacity = DEFAULT_RING
        _recorder = TraceRecorder(capacity)
    return _recorder


def disable() -> None:
    global _recorder
    _recorder = None


def enabled() -> bool:
    return _recorder is not None


def get_recorder() -> Optional[TraceRecorder]:
    return _recorder


def maybe_enable_from_env() -> Optional[TraceRecorder]:
    if env_enabled():
        return enable()
    return None


def span(name: str, step: Optional[int] = None, **args):
    """``with span("compile"): ...`` — no-op singleton when disabled."""
    rec = _recorder
    if rec is None:
        return NOOP_SPAN
    return _Span(rec, name, step, args or None)


def event(name: str, step: Optional[int] = None, **args) -> None:
    """Record an instant event (e.g. a supervisor verdict)."""
    rec = _recorder
    if rec is not None:
        rec.add_event(name, step, args or None)


# --------------------------------------------------------------------- #
# clock skew + chrome trace merging (driver side)
# --------------------------------------------------------------------- #
def estimate_skew(samples: Sequence[Tuple[float, float]]) -> float:
    """Estimate a rank's wall-clock skew (worker clock minus driver
    clock) from heartbeat ``(send_wall, recv_wall)`` pairs.

    With skew ``k`` and one-way latency ``l >= 0``, ``send - recv =
    k - l``, so the maximum over many beats approaches ``k`` minus the
    floor one-way latency — the one-directional NTP bound. Subtracting
    the estimate from a rank's timestamps aligns its timeline to the
    driver's clock to within that latency floor, which is what makes
    cross-rank span overlap readable in the merged trace.
    """
    if not samples:
        return 0.0
    return max(send - recv for send, recv in samples)


def _pid_for(rank) -> int:
    # driver gets pid 0; worker rank r gets pid r+1 so two distinct rank
    # tracks never collapse onto the driver track
    return 0 if rank == DRIVER else int(rank) + 1


def to_chrome_events(
    rank, events: Iterable[TraceTuple], skew: float = 0.0
) -> List[Dict[str, Any]]:
    """One rank's trace tuples -> Chrome trace event dicts (ts/dur in µs).

    Events whose args carry :data:`TRACK_ARG` are assigned a stable
    per-track tid (> 0) within the rank's process, with ``thread_name``
    metadata appended, so each named track (e.g. one serving request)
    renders as its own row under the rank's process in Perfetto.
    """
    pid = _pid_for(rank)
    out: List[Dict[str, Any]] = []
    tracks: Dict[str, int] = {}
    for kind, name, wall, dur, step, args in events:
        a = dict(args) if args else {}
        track = a.pop(TRACK_ARG, None)
        tid = 0
        if track is not None:
            track = str(track)
            tid = tracks.get(track)
            if tid is None:
                tid = tracks[track] = len(tracks) + 1
        ev: Dict[str, Any] = {
            "name": name,
            "ph": kind,
            "ts": (wall - skew) * 1e6,
            "pid": pid,
            "tid": tid,
        }
        if kind == "X":
            ev["dur"] = dur * 1e6
        elif kind == "i":
            ev["s"] = "t"
        if step is not None:
            a["step"] = int(step)
        if a:
            ev["args"] = a
        out.append(ev)
    for track, tid in tracks.items():
        out.append(
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": track}}
        )
        out.append(
            {"name": "thread_sort_index", "ph": "M", "pid": pid, "tid": tid,
             "args": {"sort_index": tid}}
        )
    return out


def flow_pair(
    flow_id: int,
    name: str,
    src: Tuple[int, int, float],
    dst: Tuple[int, int, float],
    cat: str = "lineage",
) -> List[Dict[str, Any]]:
    """A Chrome flow-event pair — ``ph:"s"`` at ``src`` and ``ph:"f"``
    at ``dst``, each ``(pid, tid, wall_seconds)`` — rendering as one
    arrow between two tracks in Perfetto. Used by the lineage
    reconstructor to connect a request's hops across replica processes
    (prefill slice → shipment → decode slice). ``bp:"e"`` binds the
    finish point to the enclosing slice so the arrow lands on the hop
    span rather than the next event on the track."""
    src_pid, src_tid, src_ts = src
    dst_pid, dst_tid, dst_ts = dst
    fid = int(flow_id) & 0x7FFFFFFF
    return [
        {"name": name, "cat": cat, "ph": "s", "id": fid,
         "ts": src_ts * 1e6, "pid": int(src_pid), "tid": int(src_tid)},
        {"name": name, "cat": cat, "ph": "f", "bp": "e", "id": fid,
         "ts": dst_ts * 1e6, "pid": int(dst_pid), "tid": int(dst_tid)},
    ]


def merge_traces(
    events_by_rank: Dict[Any, List[TraceTuple]],
    skew_by_rank: Optional[Dict[Any, float]] = None,
) -> Dict[str, Any]:
    """Merge per-rank rings into one Chrome/Perfetto trace object.

    ``events_by_rank`` maps rank (int, or :data:`DRIVER`) to trace tuples;
    ``skew_by_rank`` carries per-rank clock-skew seconds (subtracted from
    every timestamp of that rank). Load the resulting JSON in
    ``ui.perfetto.dev`` or ``chrome://tracing``.
    """
    skew_by_rank = skew_by_rank or {}
    trace_events: List[Dict[str, Any]] = []
    for rank in sorted(events_by_rank, key=_pid_for):
        pid = _pid_for(rank)
        label = DRIVER if rank == DRIVER else f"rank {int(rank)}"
        trace_events.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": label}}
        )
        trace_events.append(
            {"name": "process_sort_index", "ph": "M", "pid": pid, "tid": 0,
             "args": {"sort_index": pid}}
        )
        trace_events.extend(
            to_chrome_events(
                rank, events_by_rank[rank], skew_by_rank.get(rank, 0.0)
            )
        )
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}
