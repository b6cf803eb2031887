"""The main process's watch over a worker group's health
(``ray_lightning_tpu/runtime/supervisor.py``).

A worker that crashes settles its future (the connection is lost), but one
that hangs (a wedged collective, a stuck write, a deadlock) settles nothing,
and the launcher would wait forever. So each worker's Trainer publishes
``(rank, step, wall_time)`` beats through the session (throttled to
``heartbeat_interval``), and a :class:`Supervisor` thread in the main
process watches their ages.

Classification (:func:`classify`):

- ``crash``: the worker process is gone. Left to the lost connection, which
  already raises ``ActorError(is_process_failure=True)``.
- ``hung``: the process lives but has not beaten for more than
  ``hang_timeout``. The supervisor records a :class:`WorkerHangError` and
  then kills the whole group (the survivors wait in collectives with the
  hung rank); ``process_results`` polls :meth:`Supervisor.poll`, raises it,
  and the launcher's ``max_failures`` relaunch resumes from the newest
  checkpoint, as after a crash.
- ``slow``: no beat for more than half of ``hang_timeout``: a straggler
  warning, once an incident; nothing is killed.

A rank arms its watchdog at its first beat: start-up (spawn, rendezvous,
the first kernel build) takes as long as it takes (the JAX supervisor's
optional ``startup_timeout`` is not ported: no caller sets it). A beat of
step -1 (``DONE``) says
that the rank's stage has returned: the supervisor stops watching it, since
gathering and sending back its results beat no more.

Elastic groups (``runtime/elastic.py``): ``on_hung(ranks)``, when set,
is offered the hung ranks first; returning True means the group shrank
around them (or they are mid-transition), and the supervisor forgets them
(``forget_rank``) and keeps watching the others instead of tripping. A
forgotten rank's next beat re-arms it; ``track_rank`` watches a spare that
was admitted. A hook that returns False or raises trips the group as before.

The aggregator tap: an ``aggregator`` (any object with ``on_beat(rank,
step, wall_time, payload)``, ``heartbeat_age(rank, age)`` and
``record_event(kind, **fields)``) receives every beat, the
``(rank, step, wall_time, payload)`` beats' telemetry payloads included,
each rank's beat age at every check (and its last at its ``DONE``), and
the straggler and hang events. The launcher's ``DriverAggregator``
(``observability/aggregator.py``) is one, on the training paths; the
serving fleet's load tap is another (``serving/replica.py``). With
``hang_timeout`` None the supervisor only pumps the beats into it. An
``slo_monitor`` (``observability/slo.SLOMonitor``) is evaluated at every
check, and its ``slo_breach`` / ``slo_clear`` verdicts are recorded as
events, so a monitor-only supervisor reports burn rates too (give the
monitor to the supervisor or to its aggregator, not to both, or each
verdict is recorded twice).
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch.runtime.actor import ActorError

logger = logging.getLogger(__name__)

OK = "ok"
SLOW = "slow"
HUNG = "hung"

# a straggler warning fires when a rank's silence passes this share of
# hang_timeout
SLOW_RATIO = 0.5

# the step of a rank's last beat, sent when its stage has returned
DONE = -1


class WorkerHangError(ActorError):
    """The supervisor declared a worker group hung and killed it. A process
    failure, so that the launcher relaunches it as it would after a crash."""

    def __init__(self, message: str):
        super().__init__(message, is_process_failure=True)


@dataclass
class WorkerHealth:
    """What the supervisor knows of one rank."""

    rank: int
    last_step: int = -1
    last_beat: Optional[float] = None  # monotonic; None before the first
    started: float = field(default_factory=time.monotonic)
    warned_slow: bool = False
    max_gap: float = 0.0  # the longest time between two beats


def classify(health: WorkerHealth, now: float, hang_timeout: float,
             slow_ratio: float = SLOW_RATIO) -> str:
    """One rank's verdict: ``"ok"``, ``"slow"`` or ``"hung"``. Silence
    before the first beat is ok."""
    if health.last_beat is None:
        return OK
    age = now - health.last_beat
    if age > hang_timeout:
        return HUNG
    if age > hang_timeout * slow_ratio:
        return SLOW
    return OK


class Supervisor:
    """Watches one worker group from a daemon thread of the main process.

    ``drain`` returns the beats received since its last call (the heartbeat
    queue's ``get_all``); ``kill_group`` kills every worker at once;
    ``is_alive(rank)`` tells a dead process (a crash, left to the lost
    connection) from a hung one."""

    def __init__(self, num_workers: int,
                 drain: Callable[[], List[Tuple[int, int, float]]],
                 hang_timeout: Optional[float],
                 heartbeat_interval: float = 1.0,
                 kill_group: Optional[Callable[[], None]] = None,
                 is_alive: Optional[Callable[[int], bool]] = None,
                 label: str = "workers",
                 on_hung: Optional[Callable[[List[int]], bool]] = None,
                 aggregator: Optional[Any] = None,
                 slo_monitor: Optional[Any] = None):
        # a timeout below two heartbeat periods would flag healthy workers:
        # clamp it, so the two arguments stay independent. None or 0 only
        # watches
        self.hang_timeout = (max(float(hang_timeout), 2.0 * heartbeat_interval)
                             if hang_timeout else None)
        self.heartbeat_interval = float(heartbeat_interval)
        self._drain = drain
        self._kill_group = kill_group
        self._is_alive = is_alive
        self._label = label
        self.on_hung = on_hung
        self._aggregator = aggregator
        self._slo_monitor = slo_monitor
        self.health: Dict[int, WorkerHealth] = {
            r: WorkerHealth(rank=r) for r in range(num_workers)}
        # the ranks whose stage returned, with their last health
        self.finished: Dict[int, Optional[WorkerHealth]] = {}
        self._verdict: Optional[WorkerHangError] = None
        self._verdict_lock = threading.Lock()
        # the tripped ranks' silence at the trip
        self.silence_at_trip: Dict[int, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._poll_interval = max(0.02, min(self.heartbeat_interval / 2.0, 0.25))

    # ------------------------------------------------------------------ #
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="torchrt-supervisor")
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # ------------------------------------------------------------------ #
    def ingest(self, beat) -> None:
        """One drained beat, ``(rank, step, wall_time)`` or ``(rank, step,
        wall_time, payload)``; malformed beats are dropped."""
        payload = None
        try:
            if len(beat) == 4:
                rank, step, wall, payload = beat
            else:
                rank, step, wall = beat
        except (TypeError, ValueError):
            return
        self.observe(rank, step, wall, payload=payload)

    def observe(self, rank: int, step: int, wall_time: float,
                payload: Optional[dict] = None) -> None:
        """Take one beat (the thread calls it for each drained beat) and
        hand it to the aggregator; a ``DONE`` beat ends the watch of its
        rank."""
        if int(step) == DONE:
            h = self.finished[rank] = self.health.pop(rank, None)
            if h is not None and h.last_beat is not None:
                # the rank's last age: a stage shorter than one poll would
                # otherwise never publish one
                self._publish_age(rank, time.monotonic() - h.last_beat)
            return
        h = self.health.get(rank)
        if h is None:
            h = self.health[rank] = WorkerHealth(rank=rank)
        now = time.monotonic()
        if h.last_beat is not None:
            h.max_gap = max(h.max_gap, now - h.last_beat)
        h.last_beat = now
        h.last_step = max(h.last_step, int(step))
        h.warned_slow = False  # a fresh beat ends the incident
        agg = self._aggregator
        if agg is not None:
            try:
                agg.on_beat(rank, step, wall_time, payload)
            except Exception:  # the tap must never break supervision
                logger.debug("aggregator.on_beat failed", exc_info=True)

    def check(self, now: Optional[float] = None) -> Dict[int, str]:
        """Every rank's verdict; warns once of a straggler. A supervisor
        without ``hang_timeout`` reports every rank ok."""
        now = time.monotonic() if now is None else now
        out: Dict[int, str] = {}
        if self._slo_monitor is not None:
            try:
                for v in self._slo_monitor.evaluate():
                    self._record_event(v.pop("event"), **v)
            except Exception:  # SLO math must never break supervision
                logger.debug("slo evaluate failed", exc_info=True)
        for rank, h in list(self.health.items()):
            if h.last_beat is not None:
                self._publish_age(rank, now - h.last_beat)
            if self.hang_timeout is None:
                out[rank] = OK
                continue
            verdict = classify(h, now, self.hang_timeout)
            if verdict == SLOW and not h.warned_slow:
                h.warned_slow = True
                silent = now - (h.last_beat or h.started)
                logger.warning(
                    "rank %d is straggling: no heartbeat for %.1fs (last step "
                    "%d, hang_timeout %.1fs)", rank, silent, h.last_step,
                    self.hang_timeout)
                self._record_event("straggler", rank=rank,
                                   silent_s=round(silent, 3),
                                   last_step=h.last_step,
                                   hang_timeout=self.hang_timeout)
            out[rank] = verdict
        return out

    def _publish_age(self, rank: int, age: float) -> None:
        agg = self._aggregator
        if agg is not None:
            try:
                agg.heartbeat_age(rank, age)
            except Exception:
                logger.debug("aggregator.heartbeat_age failed", exc_info=True)

    def forget_rank(self, rank: int, drop_telemetry: bool = False) -> None:
        """Stop watching ``rank`` (evicted by a shrink, or mid-transition: a
        later beat re-arms it). ``drop_telemetry`` also asks the aggregator,
        where it has a ``drop_rank``, to forget the rank (a permanent
        eviction only)."""
        self.health.pop(rank, None)
        if drop_telemetry and self._aggregator is not None:
            try:
                self._aggregator.drop_rank(rank)
            except Exception:
                logger.debug("aggregator.drop_rank failed", exc_info=True)

    def track_rank(self, rank: int) -> None:
        """Watch a newly admitted rank (an elastic grow), armed at its first
        beat."""
        self.health[rank] = WorkerHealth(rank=rank)

    def _record_event(self, kind: str, **fields) -> None:
        agg = self._aggregator
        if agg is not None:
            try:
                agg.record_event(kind, label=self._label, **fields)
            except Exception:
                logger.debug("aggregator.record_event failed", exc_info=True)

    # ------------------------------------------------------------------ #
    def poll(self) -> None:
        """Raise the hang verdict if there is one; else return at once (the
        launcher's wait calls it each round)."""
        with self._verdict_lock:
            if self._verdict is not None:
                raise self._verdict

    @property
    def tripped(self) -> bool:
        with self._verdict_lock:
            return self._verdict is not None

    def _run(self) -> None:
        while not self._stop.wait(self._poll_interval):
            try:
                for beat in self._drain() or []:
                    self.ingest(beat)
            except Exception:
                # a heartbeat queue that dies in a teardown must not stop
                # the thread: silence ages the ranks out
                logger.debug("supervisor: drain failed", exc_info=True)
            hung = sorted(r for r, v in self.check().items() if v == HUNG)
            # a dead process ages out too: that is a crash, which the lost
            # connection reports better
            if hung and self._is_alive is not None:
                try:
                    hung = [r for r in hung if self._is_alive(r)]
                except Exception:
                    logger.debug("supervisor: is_alive failed", exc_info=True)
            if hung and self.on_hung is not None:
                try:
                    absorbed = bool(self.on_hung(list(hung)))
                except Exception:
                    logger.exception("supervisor: on_hung hook failed")
                    absorbed = False
                if absorbed:
                    # the group shrank around them, or they are deferred
                    for r in hung:
                        self.forget_rank(r)
                    continue
            if hung:
                self._trip(hung)
                return

    def _trip(self, hung: List[int]) -> None:
        now = time.monotonic()
        silence = {r: now - (self.health[r].last_beat or self.health[r].started)
                   for r in hung}
        detail = ", ".join(f"rank {r} (last step {self.health[r].last_step}, "
                           f"silent {silence[r]:.1f}s)" for r in hung)
        msg = (f"{self._label}: hang detected — no heartbeat within "
               f"hang_timeout={self.hang_timeout:.1f}s from {detail}; killing "
               "the worker group")
        logger.error(msg)
        self._record_event("hang", ranks=hung,
                           last_steps={r: self.health[r].last_step
                                       for r in hung},
                           hang_timeout=self.hang_timeout)
        # the verdict before the kill: once the workers die their futures
        # settle as lost connections, and the poller must see the hang first
        with self._verdict_lock:
            self._verdict = WorkerHangError(msg)
            self.silence_at_trip = silence
        if self._kill_group is not None:
            try:
                self._kill_group()
            except Exception:
                logger.exception("supervisor: killing the worker group failed")
