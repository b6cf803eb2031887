"""Request-scoped tracing for the serving stack
(``ray_lightning_tpu/observability/reqtrace.py``).

A :class:`RequestTrace` is minted at ``InferenceEngine.submit`` (or at
``import_shipment`` for a migrated hop, seeded from the shipment's
:class:`TraceContext`) and threaded, as one attribute on the scheduler's
:class:`~..serving.scheduler.Request` and on the KV pool's
:class:`~..serving.kv_pool.Slot`, through admission, block-pool deferral,
prefill and every decode tick. It accumulates the request's timeline:
queue wait, deferred-block wait, prefill duration, TTFT and the per-token
ITL stamps.

On finish the :class:`RequestTracer`:

- emits ``req/queue_wait`` / ``req/deferred_block_wait`` / ``req/prefill``
  / ``req/decode`` spans into the process trace ring, tagged with the
  :data:`~.trace.TRACK_ARG` arg so the merged ``trace.json`` renders one
  Perfetto track per request under its rank's process;
- observes the record's TTFT components into the
  ``rlt_serve_ttft_component_seconds`` histograms;
- appends a JSON record to ``requests.jsonl`` (locally when an output
  dir is known) and buffers it for heartbeat shipping or a local dump.

Head-based sampling: the keep/drop verdict is taken once at submit from
``TORCHRT_TRACE_SAMPLE`` (a fraction in [0, 1], default 1.0 when telemetry
is on) by hashing the base request id with crc32, the JAX package's rule,
so one rid is sampled alike in both packages and every hop of a request
shares the verdict. An unsampled request costs the same single attribute
``None`` check a token as with telemetry off.

The file layer (the size-rotated :class:`JsonlWriter` behind
``events.jsonl`` and ``requests.jsonl``, the rotation-stitched
:func:`read_window` that incident bundles and lineage read, and the
request-id grammar) is shared with the training path's recorder.
"""
from __future__ import annotations

import json
import os
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import metrics, trace

SAMPLE_ENV = "TORCHRT_TRACE_SAMPLE"
EVENTS_MAX_ENV = "TORCHRT_EVENTS_MAX_BYTES"

REQUESTS_FILE = "requests.jsonl"

# JSONL writers rotate once past this size unless the env overrides.
DEFAULT_MAX_JSONL_BYTES = 64 * 1024 * 1024
# Per-request ITL stamp cap (offsets from the first token, seconds).
MAX_TOKEN_STAMPS = 512
# Finished records buffered for heartbeat drain before the oldest drop.
MAX_PENDING_RECORDS = 1024


def sample_rate(environ=os.environ) -> float:
    raw = environ.get(SAMPLE_ENV)
    if raw is None:
        return 1.0
    try:
        rate = float(raw)
    except ValueError:
        return 1.0
    return min(1.0, max(0.0, rate))


def head_sampled(request_id: str, rate: float) -> bool:
    """Deterministic head-sampling verdict for one request id."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = zlib.crc32(str(request_id).encode("utf-8", "replace")) & 0xFFFFFFFF
    return h < rate * 2.0**32


def disposition_for(finish_reason: str) -> str:
    """Collapse a finish reason into the client-facing disposition
    (completed / shed / expired / cancelled / migrated / failed).

    ``migrated`` is a per-hop disposition, not a client outcome: the
    prefill-side hop of a disaggregated request finishes with it when its
    KV shipment is admitted downstream, and the decode-side hop carries
    the client-facing outcome."""
    if finish_reason in ("eos", "length"):
        return "completed"
    if finish_reason in ("shed", "expired", "cancelled", "migrated"):
        return finish_reason
    return "failed"


def base_rid(request_id: str) -> str:
    """Strip the attempt suffix (``~rN`` retry / ``~mK`` migration) off an
    attempt rid, recovering the client-facing base request id."""
    return str(request_id).split("~", 1)[0]


@dataclass(frozen=True)
class TraceContext:
    """Hop-carrying lineage context for one request attempt.

    Minted by whichever layer hands a request to its next execution site —
    fleet dispatch (hop 0 and retry hops) or ``export_shipment`` (a KV
    shipment leaving a prefill replica) — and consumed by
    :meth:`RequestTracer.start` on the receiving side, so every hop's
    :class:`RequestTrace` knows its position in the request's causal
    history (hop index, parent attempt rid, origin replica) and carries
    the TTFT seconds already spent upstream.

    ``hop`` is the hop index of the *receiving* attempt; ``rid`` is the
    parent attempt's rid (equal to the receiver's own rid on hop 0, which
    means "no parent"). ``components`` accumulates the upstream TTFT
    decomposition; the receiver charges the wall-clock gap between
    ``sent_wall`` and its own submit stamp to ``gap_component``
    (``dispatch`` for queue hand-offs, ``transfer`` for KV shipments), so
    the decomposition telescopes across hops with nothing counted twice
    and no instant dropped."""

    rid: str
    base_rid: str
    attempt: int = 1
    hop: int = 0
    origin_replica: Optional[Any] = None
    sent_wall: float = 0.0
    components: Dict[str, float] = field(default_factory=dict)
    gap_component: str = "dispatch"
    tenant: Optional[str] = None


def jsonl_max_bytes(environ=os.environ) -> int:
    try:
        return int(environ.get(EVENTS_MAX_ENV, DEFAULT_MAX_JSONL_BYTES))
    except ValueError:
        return DEFAULT_MAX_JSONL_BYTES


class JsonlWriter:
    """Append-mode JSONL writer with single-generation size rotation.

    Once the file passes ``max_bytes`` it is renamed to ``<path>.1``
    (replacing the previous rotation) and a fresh file is started, so
    multi-day runs hold at most two generations on disk. ``max_bytes <=
    0`` disables rotation. Used for ``events.jsonl`` and
    ``requests.jsonl``.
    """

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = jsonl_max_bytes() if max_bytes is None else int(max_bytes)
        self.rotations = 0
        self._fh = None
        self._bytes = 0

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, sort_keys=True) + "\n"
        if self._fh is None:
            self._open()
        try:
            self._fh.write(line)
            self._fh.flush()
        except (OSError, ValueError):
            return
        self._bytes += len(line)
        if 0 < self.max_bytes <= self._bytes:
            self._rotate()

    def _open(self) -> None:
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        try:
            self._bytes = self._fh.tell()
        except OSError:
            self._bytes = 0

    def _rotate(self) -> None:
        self.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self.rotations += 1
        self._bytes = 0

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:
                pass
            self._fh = None

    def read_window(
        self, max_bytes: int = 256 * 1024, rotated_floor: float = 0.5
    ) -> List[str]:
        """Trailing window of this writer's records — see
        :func:`read_window`. Flushes nothing (``write`` already flushes
        per line) but stitches the live file with its rotation, so a
        reader never loses the seconds straddling a rotation boundary."""
        return read_window(self.path, max_bytes, rotated_floor=rotated_floor)


def read_window(
    path: str, max_bytes: int = 256 * 1024, rotated_floor: float = 0.5
) -> List[str]:
    """The last ``max_bytes`` worth of JSONL lines ending at ``path``'s
    tail, stitched across the single-generation rotation, returned
    oldest-first. A partially-included first line (the seek landed
    mid-record) is dropped rather than returned corrupt.

    When both generations exist, ``rotated_floor`` (fraction of the
    budget) is reserved for the ``<path>.1`` tail before the live file
    spends the rest. Without the floor, a live file larger than the
    window starves the rotated generation entirely — and a rotation
    mid-burst splits one request's hop records across the boundary, so a
    lineage reconstructor reading only the live side sees orphan hops.
    The floor still trims from the OLD side first: the live file's last
    complete line is always kept, however small the budget."""
    budget = max(0, int(max_bytes))
    live, rotated = path, path + ".1"
    sizes: Dict[str, int] = {}
    for p in (live, rotated):
        try:
            sizes[p] = os.path.getsize(p)
        except OSError:
            sizes[p] = 0

    def _tail_lines(p: str, take: int) -> List[bytes]:
        size = sizes[p]
        if take <= 0 or size <= 0:
            return []
        take = min(take, size)
        try:
            with open(p, "rb") as fh:
                fh.seek(size - take)
                data = fh.read(take)
        except OSError:
            return []
        if take < size:
            # the seek landed mid-record: drop the corrupt first line
            nl = data.find(b"\n")
            data = data[nl + 1:] if nl >= 0 else b""
        return [ln for ln in data.splitlines() if ln.strip()]

    live_lines = _tail_lines(live, budget)
    reserve = 0
    if live_lines and sizes[rotated] > 0:
        floor = max(0.0, min(1.0, float(rotated_floor)))
        reserve = min(sizes[rotated], int(budget * floor))
    if reserve:
        # give the rotated generation its reserve by shedding the live
        # tail's OLDEST lines — but never its newest complete line
        keep = budget - reserve
        spent = sum(len(ln) + 1 for ln in live_lines)
        while len(live_lines) > 1 and spent > keep:
            spent -= len(live_lines[0]) + 1
            live_lines = live_lines[1:]
        reserve = budget - spent
    rotated_take = budget if not live_lines else reserve
    rotated_lines = _tail_lines(rotated, rotated_take)
    return [
        ln.decode("utf-8", "replace") for ln in rotated_lines + live_lines
    ]


class RequestTrace:
    """Mutable timeline of one in-flight request (perf_counter based,
    anchored to a wall time at submit for trace export)."""

    __slots__ = (
        "request_id", "prompt_len", "max_new_tokens", "replica",
        "submitted_wall", "_submitted", "_admitted", "_first_deferred",
        "deferred_ticks", "prefill_s", "_prefill_done", "_first_token",
        "_last_token", "tokens", "token_stamps", "slot",
        "hbm_bytes_in_use", "retries", "hop", "parent_rid",
        "origin_replica", "pool", "ctx_components", "ctx_sent_wall",
        "gap_component", "tenant",
    )

    def __init__(
        self,
        request_id: str,
        prompt_len: int = 0,
        max_new_tokens: int = 0,
        replica: Optional[Any] = None,
        retries: int = 0,
        ctx: Optional[TraceContext] = None,
        pool: Optional[str] = None,
        tenant: Optional[str] = None,
    ):
        self.request_id = str(request_id)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.replica = replica
        self.retries = int(retries)
        self.pool = pool
        self.tenant = tenant if tenant is not None else (
            ctx.tenant if ctx is not None else None
        )
        if ctx is not None:
            self.hop = int(ctx.hop)
            self.parent_rid = ctx.rid if ctx.rid != self.request_id else None
            self.origin_replica = ctx.origin_replica
            self.ctx_components = dict(ctx.components) if ctx.components else {}
            self.ctx_sent_wall = ctx.sent_wall or None
            self.gap_component = ctx.gap_component
        else:
            self.hop = 0
            self.parent_rid = None
            self.origin_replica = None
            self.ctx_components = {}
            self.ctx_sent_wall = None
            self.gap_component = "dispatch"
        self.submitted_wall = time.time()
        self._submitted = time.perf_counter()
        self._admitted: Optional[float] = None
        self._first_deferred: Optional[float] = None
        self.deferred_ticks = 0
        self.prefill_s: Optional[float] = None
        self._prefill_done: Optional[float] = None
        self._first_token: Optional[float] = None
        self._last_token: Optional[float] = None
        self.tokens = 0
        self.token_stamps: List[float] = []
        self.slot: Optional[int] = None
        self.hbm_bytes_in_use: Optional[int] = None

    # ------------------------------------------------------------- #
    # lifecycle stamps (called from scheduler/engine hot paths)
    # ------------------------------------------------------------- #
    def deferred(self) -> None:
        """The scheduler peeked but could not admit (slot/block pressure)."""
        self.deferred_ticks += 1
        if self._first_deferred is None:
            self._first_deferred = time.perf_counter()

    def admitted(self, slot: Optional[int] = None) -> None:
        if self._admitted is None:
            self._admitted = time.perf_counter()
            self.slot = slot
            stats = metrics.last_device_memory()
            if stats:
                self.hbm_bytes_in_use = sum(s["bytes_in_use"] for s in stats)

    def prefilled(self, duration_s: float) -> None:
        self.prefill_s = float(duration_s)
        self._prefill_done = time.perf_counter()

    def token(self) -> None:
        now = time.perf_counter()
        if self._first_token is None:
            self._first_token = now
        elif len(self.token_stamps) < MAX_TOKEN_STAMPS:
            self.token_stamps.append(now - self._first_token)
        self.tokens += 1
        self._last_token = now

    # ------------------------------------------------------------- #
    # derived timings
    # ------------------------------------------------------------- #
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self._admitted is None:
            return None
        return self._admitted - self._submitted

    @property
    def deferred_wait_s(self) -> float:
        if self._first_deferred is None:
            return 0.0
        end = self._admitted if self._admitted is not None else time.perf_counter()
        return max(0.0, end - self._first_deferred)

    @property
    def ttft_s(self) -> Optional[float]:
        if self._first_token is None:
            return None
        return self._first_token - self._submitted

    @property
    def total_s(self) -> float:
        end = self._last_token if self._last_token is not None else time.perf_counter()
        return end - self._submitted

    def itls(self) -> List[float]:
        """Inter-token latencies reconstructed from the stamp list."""
        prev = 0.0
        out = []
        for s in self.token_stamps:
            out.append(s - prev)
            prev = s
        return out

    def _wall(self, perf_t: float) -> float:
        return self.submitted_wall + (perf_t - self._submitted)

    # ------------------------------------------------------------- #
    # TTFT decomposition (telescoping across hops)
    # ------------------------------------------------------------- #
    def local_components(self) -> Dict[str, float]:
        """This hop's own TTFT segments, back-to-back on one clock:
        submit → admitted (``queue_wait``), admitted → prefill done
        (``prefill``), last stamp → first token (``decode``). Their sum
        is exactly submit → first-token on this hop, because each
        segment starts where the previous one ended."""
        out: Dict[str, float] = {}
        if self._admitted is not None:
            out["queue_wait"] = max(0.0, self._admitted - self._submitted)
        if self._prefill_done is not None:
            start = self._admitted if self._admitted is not None else self._submitted
            out["prefill"] = max(0.0, self._prefill_done - start)
        if self._first_token is not None:
            start = self._prefill_done
            if start is None:
                start = self._admitted if self._admitted is not None else self._submitted
            out["decode"] = max(0.0, self._first_token - start)
        return out

    def ttft_components(self) -> Dict[str, float]:
        """Cumulative TTFT decomposition through this hop: upstream
        components carried by the :class:`TraceContext`, the inter-hop
        gap (charged to the context's ``gap_component``), and this hop's
        local segments. On the hop that emits the first token the values
        sum — telescoping, no double counting — to the request's
        end-to-end submit → first-token time."""
        out = dict(self.ctx_components) if self.ctx_components else {}
        if self.ctx_sent_wall:
            gap = max(0.0, self.submitted_wall - self.ctx_sent_wall)
            out[self.gap_component] = out.get(self.gap_component, 0.0) + gap
        for name, val in self.local_components().items():
            out[name] = out.get(name, 0.0) + val
        return out

    def export_context(self) -> TraceContext:
        """The :class:`TraceContext` for this request's NEXT hop — a KV
        shipment leaving this replica. Carries everything accumulated
        through this hop plus ``export_wait`` (prefill done → send), and
        stamps the send wall-clock so the receiver charges the in-flight
        gap to ``transfer``."""
        now = time.perf_counter()
        comps = self.ttft_components()
        anchor = self._prefill_done
        if anchor is None:
            anchor = self._admitted if self._admitted is not None else self._submitted
        comps["export_wait"] = comps.get("export_wait", 0.0) + max(0.0, now - anchor)
        origin = self.origin_replica if self.origin_replica is not None else self.replica
        return TraceContext(
            rid=self.request_id,
            base_rid=base_rid(self.request_id),
            attempt=self.retries + 1,
            hop=self.hop + 1,
            origin_replica=origin,
            sent_wall=self._wall(now),
            components=comps,
            gap_component="transfer",
        )

    def record(self, finish_reason: str) -> Dict[str, Any]:
        """The finished-request JSON record (one ``requests.jsonl`` line)."""
        itls = self.itls()
        rec: Dict[str, Any] = {
            "ts": round(self._wall(time.perf_counter()), 6),
            "request_id": self.request_id,
            "prompt_len": self.prompt_len,
            "tokens_out": self.tokens,
            "finish_reason": finish_reason,
            "disposition": disposition_for(finish_reason),
            "retries": self.retries,
            "deferred_ticks": self.deferred_ticks,
            "total_s": round(self.total_s, 6),
        }
        for key, val in (
            ("queue_wait_s", self.queue_wait_s),
            ("deferred_wait_s", self.deferred_wait_s or None),
            ("prefill_s", self.prefill_s),
            ("ttft_s", self.ttft_s),
        ):
            if val is not None:
                rec[key] = round(val, 6)
        if itls:
            rec["itl_p50_ms"] = round(
                metrics.percentile(itls, 50) * 1e3, 3
            )
            rec["itl_max_ms"] = round(max(itls) * 1e3, 3)
        if self.slot is not None:
            rec["slot"] = self.slot
        if self.replica is not None:
            rec["replica"] = self.replica
        if self.hbm_bytes_in_use is not None:
            rec["hbm_bytes_in_use"] = self.hbm_bytes_in_use
        rec["start_ts"] = round(self.submitted_wall, 6)
        rec["hop"] = self.hop
        base = base_rid(self.request_id)
        if base != self.request_id:
            rec["base_rid"] = base
        if self.parent_rid:
            rec["parent_rid"] = self.parent_rid
        if self.origin_replica is not None:
            rec["origin_replica"] = self.origin_replica
        if self.pool:
            rec["pool"] = self.pool
        if self.tenant is not None:
            rec["tenant"] = self.tenant
        if self.ctx_sent_wall and self.gap_component == "transfer":
            rec["transfer_s"] = round(
                max(0.0, self.submitted_wall - self.ctx_sent_wall), 6
            )
        comps = self.ttft_components()
        if comps:
            rec["ttft_components"] = {k: round(v, 6) for k, v in comps.items()}
            if self._first_token is not None:
                rec["ttft_total_s"] = round(sum(comps.values()), 6)
        return rec

    def emit_spans(self, recorder: trace.TraceRecorder, finish_reason: str) -> None:
        """Replay the timeline into the trace ring as one track per request."""
        track = f"req {self.request_id}"
        if self._admitted is not None:
            recorder.add_span(
                "req/queue_wait",
                self._wall(self._submitted),
                self._admitted - self._submitted,
                args={trace.TRACK_ARG: track},
            )
        if self._first_deferred is not None and self._admitted is not None:
            recorder.add_span(
                "req/deferred_block_wait",
                self._wall(self._first_deferred),
                self.deferred_wait_s,
                args={trace.TRACK_ARG: track, "ticks": self.deferred_ticks},
            )
        if self.prefill_s is not None and self._prefill_done is not None:
            recorder.add_span(
                "req/prefill",
                self._wall(self._prefill_done - self.prefill_s),
                self.prefill_s,
                args={trace.TRACK_ARG: track, "prompt_len": self.prompt_len},
            )
        if self._first_token is not None:
            end = self._last_token or self._first_token
            args: Dict[str, Any] = {
                trace.TRACK_ARG: track,
                "tokens": self.tokens,
                "reason": finish_reason,
            }
            if self.ttft_s is not None:
                args["ttft_ms"] = round(self.ttft_s * 1e3, 3)
            stamps = self.token_stamps[:128]
            if stamps:
                args["itl_stamps_ms"] = [round(s * 1e3, 3) for s in stamps]
            recorder.add_span(
                "req/decode",
                self._wall(self._first_token),
                end - self._first_token,
                args=args,
            )


class RequestTracer:
    """Per-engine request-trace book: sampling at submit, span + record
    emission at finish, bounded pending buffer for heartbeat drain."""

    def __init__(
        self,
        out_dir: Optional[str] = None,
        rate: Optional[float] = None,
        pool: Optional[str] = None,
    ):
        self.pool = pool
        self.rate = sample_rate() if rate is None else min(1.0, max(0.0, rate))
        self._writer = (
            JsonlWriter(os.path.join(out_dir, REQUESTS_FILE)) if out_dir else None
        )
        self._pending: deque = deque(maxlen=MAX_PENDING_RECORDS)
        self.started_total = 0
        self.sampled_total = 0
        self.finished_total = 0

    @property
    def path(self) -> Optional[str]:
        return self._writer.path if self._writer else None

    def start(
        self,
        request_id: str,
        prompt_len: int = 0,
        max_new_tokens: int = 0,
        replica: Optional[Any] = None,
        retries: int = 0,
        ctx: Optional[TraceContext] = None,
        tenant: Optional[str] = None,
    ) -> Optional[RequestTrace]:
        """Mint a trace for a new request, or ``None`` when head sampling
        drops it (the request then costs one attribute check per tick).
        Sampling keys on the BASE rid so every hop of one request shares
        the keep/drop verdict — a lineage is whole or absent, never
        partial."""
        self.started_total += 1
        if not head_sampled(base_rid(request_id), self.rate):
            return None
        self.sampled_total += 1
        return RequestTrace(
            request_id, prompt_len, max_new_tokens, replica,
            retries=retries, ctx=ctx, pool=self.pool, tenant=tenant,
        )

    def finish(self, tr: RequestTrace, finish_reason: str) -> Dict[str, Any]:
        recorder = trace.get_recorder()
        if recorder is not None:
            tr.emit_spans(recorder, finish_reason)
        rec = tr.record(finish_reason)
        comps = rec.get("ttft_components")
        if comps and "ttft_total_s" in rec:
            reg = metrics.get_registry()
            pool = tr.pool or "serve"
            for name, secs in comps.items():
                reg.histogram(
                    metrics.SERVE_TTFT_COMPONENT_METRIC,
                    bounds=metrics.TTFT_COMPONENT_BOUNDS,
                    component=name,
                    pool=pool,
                ).observe(secs, exemplar=tr.request_id)
        self.finished_total += 1
        self._pending.append(rec)
        if self._writer is not None:
            self._writer.write(rec)
        return rec

    def drain(self) -> List[Dict[str, Any]]:
        """Pop buffered finished-request records (for a heartbeat payload)."""
        out: List[Dict[str, Any]] = []
        pending = self._pending
        while True:
            try:
                out.append(pending.popleft())
            except IndexError:
                return out

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


def read_requests(path: str, limit: int = 0) -> List[Dict[str, Any]]:
    """Load a ``requests.jsonl`` (including its ``.1`` rotation if
    present), oldest first; bad lines are skipped."""
    out: List[Dict[str, Any]] = []
    for p in (path + ".1", path):
        if not os.path.exists(p):
            continue
        with open(p, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    if limit > 0:
        out = out[-limit:]
    return out
