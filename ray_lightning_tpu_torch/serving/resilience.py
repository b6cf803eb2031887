"""Serving resilience (``ray_lightning_tpu/serving/resilience.py``): the
request journal, the circuit breaker, load shedding and the preemption
drain. Pure host logic, each piece testable without a model:

- :class:`RequestJournal` — the record of every submitted request: prompt,
  budget, deadline, priority and the tokens streamed so far. When an
  engine dies mid-stream, the caller resubmits ``prompt + delivered`` with
  ``max_new - len(delivered)`` left (``begin_attempt``), so a greedy decode
  continues token-identically. Each dispatch gets its own attempt id, and
  :meth:`RequestJournal.stream_guard` drops the tokens of any attempt that
  is no longer current (a half-dead engine's tokens land nowhere).
- :class:`CircuitBreaker` — one engine's health as closed -> open ->
  half-open: consecutive failures open it; after a cooldown exactly one
  probe goes through, whose outcome closes or re-opens it.
- :class:`ShedPolicy` — admission control: priority 0 is never shed;
  priority >= 1 is rejected past the queue watermark (or under SLO burn,
  which stays inert until an SLO monitor is ported: the engine passes
  ``slo_breached=False``). Tenant classes generalise the priority rule.
- :func:`install_sigterm_drain` — a SIGTERM handler that drains a target.

The journal holds requests, not engines: all it needs from the caller is
"dispatch this (prompt, budget) somewhere and wire my guard as on_token".
The breaker states' gauges wait for the port's metrics registry.
"""
from __future__ import annotations

import itertools
import logging
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch.serving.scheduler import RequestQueueFull

log = logging.getLogger(__name__)

__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "CircuitBreaker",
    "JournalEntry",
    "RequestJournal",
    "RequestShed",
    "ShedPolicy",
    "install_sigterm_drain",
]

DISPOSITIONS = ("completed", "shed", "expired", "failed", "quota_rejected")


class RequestShed(RequestQueueFull):
    """Rejected by the load-shed policy (SLO burn or queue watermark).

    Subclasses :class:`RequestQueueFull` so existing back-pressure
    handling (retry with backoff, count as rejected) applies unchanged.
    """


# --------------------------------------------------------------------------
# circuit breaker
# --------------------------------------------------------------------------

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

_BREAKER_GAUGE_VALUE = {
    BREAKER_CLOSED: 0,
    BREAKER_HALF_OPEN: 1,
    BREAKER_OPEN: 2,
}


class CircuitBreaker:
    """Per-replica request-outcome health, closed → open → half-open.

    ``failure_threshold`` consecutive failures open the breaker. While
    open, :meth:`allow_request` refuses everything until
    ``open_cooldown_s`` has elapsed, then lends exactly one probe
    (transitioning to half-open); further requests are refused while the
    probe is outstanding. A successful probe closes the breaker; a
    failed one re-opens it for a fresh cooldown.

    ``clock`` is injectable so tests can script cooldown expiry without
    sleeping. All methods are thread-safe (router + journal pump).
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        open_cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.failure_threshold = int(failure_threshold)
        self.open_cooldown_s = float(open_cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_outstanding = False
        # (ts, from_state, to_state) history — chaos tests assert on it
        self.transitions: List[Tuple[float, str, str]] = []
        self.failures_total = 0
        self.successes_total = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def state_value(self) -> int:
        """Gauge encoding: 0 closed, 1 half-open, 2 open."""
        return _BREAKER_GAUGE_VALUE[self.state]

    def _transition(self, to: str) -> None:
        if to != self._state:
            self.transitions.append((self._clock(), self._state, to))
            self._state = to

    def record_success(self) -> None:
        with self._lock:
            self.successes_total += 1
            self._consecutive_failures = 0
            self._probe_outstanding = False
            if self._state != BREAKER_CLOSED:
                self._transition(BREAKER_CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.failures_total += 1
            self._consecutive_failures += 1
            if self._state == BREAKER_HALF_OPEN:
                # failed probe: straight back to open, fresh cooldown
                self._probe_outstanding = False
                self._opened_at = self._clock()
                self._transition(BREAKER_OPEN)
            elif (
                self._state == BREAKER_CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._transition(BREAKER_OPEN)

    def allow_request(self) -> bool:
        """May a request be routed to this replica right now?

        The one ``True`` returned after an open breaker's cooldown IS
        the half-open probe: the caller must route that request and
        report its outcome, or the breaker stays half-open forever.
        """
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_OPEN:
                if self._clock() - self._opened_at >= self.open_cooldown_s:
                    self._transition(BREAKER_HALF_OPEN)
                    self._probe_outstanding = True
                    return True
                return False
            # half-open: one probe at a time
            if not self._probe_outstanding:
                self._probe_outstanding = True
                return True
            return False


# --------------------------------------------------------------------------
# load shedding
# --------------------------------------------------------------------------


@dataclass
class ShedPolicy:
    """When to reject low-priority work at the front door.

    Priority 0 (the default class) is never shed — it only ever sees
    queue-full back-pressure. Priority >= ``shed_priority_floor`` is
    rejected while the serving SLO burn-rate alert is firing, or once
    the admission queue crosses ``queue_watermark`` of its capacity:
    shedding the sheddable BEFORE the queue is full keeps headroom for
    the traffic that must not fail.

    Tenant classes (``serving/tenancy.py``) generalize the priority-0
    rule. Shed ordering, strongest protection first:

    1. ``guaranteed`` is NEVER shed — regardless of priority, watermark,
       or SLO burn. Its only refusals are queue-full back-pressure and
       its own quota (``quota_rejected``).
    2. ``standard`` / classless traffic sheds by the original priority
       rule above.
    3. ``best_effort`` sheds FIRST: any priority, at the lower
       ``best_effort_watermark``, and immediately whenever the SLO
       burn-rate alert fires.

    With ``tenant_class=None`` (no registry installed) the decision is
    bit-for-bit the original single-tenant policy.
    """

    queue_watermark: float = 0.9
    shed_priority_floor: int = 1
    best_effort_watermark: float = 0.7

    def should_shed(
        self,
        priority: int,
        queue_depth: int,
        max_queue: int,
        slo_breached: bool = False,
        tenant_class: Optional[str] = None,
    ) -> bool:
        if tenant_class == "guaranteed":
            return False
        if tenant_class == "best_effort":
            if slo_breached:
                return True
            return queue_depth >= self.best_effort_watermark * max_queue
        if priority < self.shed_priority_floor:
            return False
        if slo_breached:
            return True
        return queue_depth >= self.queue_watermark * max_queue


# --------------------------------------------------------------------------
# request journal
# --------------------------------------------------------------------------


class JournalEntry:
    """One journaled request: the durable record plus the caller-facing
    handle (``result()`` / ``tokens`` / ``done``, mirroring
    ``engine.Completion`` so fleet callers are oblivious to retries).

    ``delivered`` is the client-visible token stream — the merge of every
    attempt's output, appended only through the journal's stream guard,
    so it can never hold a duplicated or out-of-order token. ``attempts``
    counts dispatches; ``retries == attempts - 1``.
    """

    __slots__ = (
        "request_id", "prompt", "max_new_tokens", "eos_id", "priority",
        "deadline", "max_retries", "on_token", "delivered", "attempts",
        "migrations", "retries_counted", "replica", "replica_history",
        "attempt_rids", "attempt_rid", "attempt_completion", "disposition",
        "finish_reason", "error", "submitted_at", "first_token_at",
        "tenant", "_done", "_lock",
    )

    def __init__(
        self,
        request_id: str,
        prompt: Tuple[int, ...],
        max_new_tokens: int,
        eos_id: Optional[int],
        deadline: Optional[float],
        priority: int,
        on_token: Optional[Callable[[str, int], Any]],
        max_retries: int,
        tenant: Optional[str] = None,
    ):
        self.request_id = request_id
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline = deadline
        self.priority = int(priority)
        self.tenant = tenant
        self.on_token = on_token
        self.max_retries = int(max_retries)
        self.delivered: List[int] = []
        self.attempts = 0
        self.migrations = 0
        self.retries_counted = 0
        self.replica: Optional[int] = None
        self.replica_history: List[int] = []
        # every attempt rid ever begun, in dispatch order — the journal's
        # half of the request's hop lineage (replica_history pairs with it
        # index-for-index)
        self.attempt_rids: List[str] = []
        self.attempt_rid: Optional[str] = None
        self.attempt_completion: Optional[Any] = None
        self.disposition: Optional[str] = None
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self._done = threading.Event()
        self._lock = threading.Lock()

    # -- Completion-compatible surface ---------------------------------- #
    @property
    def tokens(self) -> List[int]:
        return self.delivered

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def retries(self) -> int:
        return max(0, self.attempts - 1)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until finished; returns the full delivered stream."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id!r} not finished within {timeout}s"
            )
        if self.error is not None:
            raise self.error
        return list(self.delivered)

    def remaining_budget(self) -> int:
        return self.max_new_tokens - len(self.delivered)

    def deadline_exceeded(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline


class RequestJournal:
    """Driver-side journal of every submitted request.

    The routing layer (fleet or group) owns dispatch; the journal owns
    the record: what was asked for, what has been delivered, how many
    attempts were spent, and the final disposition (one of
    ``completed`` / ``shed`` / ``expired`` / ``failed``).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, JournalEntry] = {}
        self._auto_id = itertools.count()
        self.retries_total = 0
        self.dispositions: Dict[str, int] = {d: 0 for d in DISPOSITIONS}

    # -- lifecycle ------------------------------------------------------- #
    def open(
        self,
        prompt: Tuple[int, ...],
        max_new_tokens: int,
        eos_id: Optional[int] = None,
        deadline: Optional[float] = None,
        priority: int = 0,
        on_token: Optional[Callable[[str, int], Any]] = None,
        max_retries: int = 2,
        request_id: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> JournalEntry:
        rid = request_id or f"jreq-{next(self._auto_id)}"
        entry = JournalEntry(
            rid, tuple(int(t) for t in prompt), max_new_tokens, eos_id,
            deadline, priority, on_token, max_retries, tenant=tenant,
        )
        with self._lock:
            if rid in self._entries:
                raise ValueError(f"duplicate request_id {rid!r}")
            self._entries[rid] = entry
        return entry

    def begin_attempt(
        self, entry: JournalEntry, replica: int, migration: bool = False
    ) -> Tuple[str, Tuple[int, ...], int]:
        """Start (re)dispatch of ``entry`` to ``replica``.

        Returns ``(attempt_rid, attempt_prompt, attempt_budget)``: the
        resubmission prompt is ``prompt + delivered`` (re-prefill from
        everything the client already has) and the budget is whatever is
        left of ``max_new_tokens`` — under greedy sampling the
        continuation is bitwise-identical to the unfaulted stream.

        ``migration=True`` marks a planned cross-pool handoff (prefill →
        decode KV shipment) rather than a failure recovery: the entry
        moves to a new replica under a fresh ``~m<K>`` attempt id, but
        ``attempts`` does NOT advance — a clean migration is not a retry
        and must not burn the request's retry budget or inflate the
        retry metrics.
        """
        with entry._lock:
            if migration:
                entry.migrations += 1
                rid = f"{entry.request_id}~m{entry.migrations}"
            else:
                entry.attempts += 1
                rid = (
                    entry.request_id
                    if entry.attempts == 1
                    else f"{entry.request_id}~r{entry.attempts - 1}"
                )
            entry.replica = replica
            entry.replica_history.append(replica)
            entry.attempt_rids.append(rid)
            entry.attempt_rid = rid
            entry.attempt_completion = None
            prompt = entry.prompt + tuple(entry.delivered)
            budget = entry.remaining_budget()
        return rid, prompt, budget

    def bind(self, entry: JournalEntry, completion: Any) -> None:
        """The attempt reached an engine queue: it is now live. Retries
        are counted here (not at begin_attempt) so a dispatch that never
        landed — engine closed, queue full, replica gone — can be
        aborted and re-tried without inflating the retry metrics. Each
        retry level is counted at most once (``retries_counted``): a
        migration bind that follows a genuine retry re-binds the same
        attempt number and must not double-count it."""
        with entry._lock:
            entry.attempt_completion = completion
            new_retries = max(0, entry.attempts - 1) - entry.retries_counted
            if new_retries > 0:
                entry.retries_counted += new_retries
        if new_retries > 0:
            with self._lock:
                self.retries_total += new_retries

    def abort_attempt(self, entry: JournalEntry) -> None:
        """Roll back a begin_attempt whose dispatch never reached an
        engine (submit raised before any work happened)."""
        with entry._lock:
            entry.attempts = max(0, entry.attempts - 1)
            entry.attempt_rid = None
            entry.attempt_completion = None

    def restore_attempt(
        self,
        entry: JournalEntry,
        replica: int,
        attempt_rid: Optional[str],
        completion: Any,
    ) -> None:
        """Point the entry back at a still-live earlier attempt after a
        failed migration: the shipment never landed (lost, corrupt,
        receiver crash, pool full), but the source replica still holds
        the prefilled slot — its attempt id and completion become current
        again, its stream guard resumes accepting tokens, and the pump's
        settle loop watches the source completion as before. No attempt
        or retry is charged: from the journal's view the request simply
        never left."""
        with entry._lock:
            entry.replica = replica
            entry.attempt_rid = attempt_rid
            entry.attempt_completion = completion

    def stream_guard(
        self, entry: JournalEntry, attempt_rid: str
    ) -> Callable[[str, int], None]:
        """The on_token callback wired into the engine for one attempt.

        Tokens are accepted only while ``attempt_rid`` is still the
        entry's CURRENT attempt and the entry is not finished — a stale
        attempt (superseded after a replica death, or a zombie replica
        still decoding) streams into the void instead of duplicating
        tokens. The client callback always sees the journal-level
        request id and the merged stream.

        Speculative decoding (``speculate_k > 0``) delivers several
        tokens per engine tick through this same callback, one call per
        token — ``delivered`` therefore stays an exact per-token replay
        log, and a resume after a mid-burst stream drop re-submits
        prompt + delivered and replays bitwise.
        """

        def on_token(_rid: str, token: int) -> None:
            with entry._lock:
                if entry.done or entry.attempt_rid != attempt_rid:
                    return
                entry.delivered.append(int(token))
                if entry.first_token_at is None:
                    entry.first_token_at = time.perf_counter()
                cb = entry.on_token
            if cb is not None:
                try:
                    cb(entry.request_id, int(token))
                except Exception:
                    pass  # a broken consumer must not stall the stream

        return on_token

    def finish(
        self,
        entry: JournalEntry,
        disposition: str,
        finish_reason: Optional[str] = None,
        error: Optional[BaseException] = None,
    ) -> None:
        if disposition not in DISPOSITIONS:
            raise ValueError(f"unknown disposition {disposition!r}")
        with entry._lock:
            if entry._done.is_set():
                return
            entry.disposition = disposition
            entry.finish_reason = finish_reason or disposition
            entry.error = error
            entry._done.set()
        with self._lock:
            self.dispositions[disposition] += 1

    # -- views ----------------------------------------------------------- #
    def get(self, request_id: str) -> Optional[JournalEntry]:
        with self._lock:
            return self._entries.get(request_id)

    def inflight(self) -> List[JournalEntry]:
        with self._lock:
            return [e for e in self._entries.values() if not e.done]

    def entries(self) -> List[JournalEntry]:
        with self._lock:
            return list(self._entries.values())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.dispositions)
            out["retries"] = self.retries_total
            out["open"] = sum(
                1 for e in self._entries.values() if not e.done
            )
        return out


# --------------------------------------------------------------------------
# preemption drain
# --------------------------------------------------------------------------


def install_sigterm_drain(
    target: Any,
    signum: int = signal.SIGTERM,
    trainer: Optional[Any] = None,
    checkpoint_path: Optional[str] = None,
) -> Callable[[int, Any], None]:
    """Install a SIGTERM handler that drains ``target`` gracefully.

    On preemption notice the handler calls ``target.preempt_all()`` when
    available (fleet/group: stop admission, migrate backlog, finish
    in-flight work) and falls back to ``target.drain()``. Returns the
    handler so tests — and embedders that multiplex signals — can invoke
    it directly. Only callable from the main thread (CPython signal
    rule); replica threads/actors never install their own.

    On a shared reservation the preemption notice covers BOTH workloads:
    pass the live ``trainer`` (anything with ``save_checkpoint(path,
    weights_only=...)``) and the handler also flushes a weights-only
    training checkpoint to ``checkpoint_path`` (default
    ``rlt_preempt_weights.ckpt`` in the working directory) before
    returning — the chips can disappear after the drain, so neither the
    in-flight requests nor the training progress is lost. Weights-only
    is deliberate: it is the fastest flush that preserves the model, and
    the resume scanner already refuses to treat it as a full resume
    point. Checkpoint failures are swallowed (the serving drain already
    ran; a broken disk must not turn a clean preemption into a crash).
    """

    def _handler(_signum: int, _frame: Any) -> None:
        drain = getattr(target, "preempt_all", None) or getattr(
            target, "drain", None
        )
        if drain is not None:
            drain()
        save = getattr(trainer, "save_checkpoint", None)
        if save is not None:
            path = checkpoint_path or "rlt_preempt_weights.ckpt"
            try:
                save(path, weights_only=True)
            except Exception:
                log.exception(
                    "preemption drain: weights-only checkpoint flush to "
                    "%s failed",
                    path,
                )

    signal.signal(signum, _handler)
    return _handler
