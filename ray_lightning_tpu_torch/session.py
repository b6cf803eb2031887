"""The per-worker session (``ray_lightning_tpu/session.py``): the worker's
rank, its queue back to the main process and its heartbeat channel. The
launcher's wrapping function calls :func:`init_session` once per trainer
entry point in each worker; ``put_queue`` hands the main process a callable
(pickled by reference) that it runs while it waits for the workers.

``heartbeat(step)`` publishes ``(rank, step, wall_time)`` beats, at most one
per ``heartbeat_interval``, to the queue that the main process's
``runtime/supervisor.py`` drains to tell live workers from hung ones;
``emit_done`` sends the last, of step -1, when the stage has returned. A
beat is lossy and never raises. With telemetry on (``observability/``) a
beat samples the device-memory gauges and carries the drained trace ring
and the metrics' delta as a fourth item, ``(rank, step, wall_time,
payload)``; ``flush_telemetry(step)`` forces one last beat with the full
snapshot when the stage returns, so a run shorter than one interval still
reaches the main process's aggregator.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

from ray_lightning_tpu_torch import observability as _obs
from ray_lightning_tpu_torch.runtime import faults
from ray_lightning_tpu_torch.runtime.supervisor import DONE

# how long a worker waits to deliver an item before it fails with an error
# that names its rank, instead of blocking training
PUT_TIMEOUT = 30.0


class RayLightningSession:
    def __init__(self, rank: int, queue: Optional[Any],
                 heartbeat: Optional[Any] = None,
                 heartbeat_interval: float = 1.0):
        self._rank = rank
        self._queue = queue
        self._heartbeat = heartbeat
        self._heartbeat_interval = max(float(heartbeat_interval), 0.01)
        self._last_beat = 0.0  # monotonic; 0: the first tick always beats

    @property
    def rank(self) -> int:
        return self._rank

    def put_queue(self, item: Callable, timeout: float = PUT_TIMEOUT) -> None:
        if self._queue is None:
            raise ValueError(
                "Trying to put something into a session queue, but no queue "
                "was configured for this run")
        try:
            self._queue.put(item, timeout=timeout)
        except Exception as e:
            raise RuntimeError(
                f"worker rank {self._rank}: could not deliver an item to the "
                f"main process's queue within {timeout}s ({type(e).__name__}: {e})"
            ) from e

    def heartbeat(self, step: int, force: bool = False) -> None:
        """Publish a liveness beat, at most one per ``heartbeat_interval``
        unless ``force``. Lossy by design: a lost beat costs nothing (the
        next one re-arms the watchdog), so a put is bounded short and every
        failure is swallowed. A beat reads no tensor: ``step`` is the host's
        counter."""
        if self._heartbeat is None:
            return
        now = time.monotonic()
        if not force and now - self._last_beat < self._heartbeat_interval:
            return
        if faults.heartbeats_dropped(step):
            return
        self._last_beat = now
        _obs.sample_device_memory()  # the memory gauges ride the beat
        payload = _obs.collect_beat_payload()
        beat = ((self._rank, int(step), time.time()) if payload is None
                else (self._rank, int(step), time.time(), payload))
        try:
            self._heartbeat.put(beat, timeout=1.0)
        except Exception:
            pass

    def flush_telemetry(self, step: int) -> None:
        """One last beat with the whole ring and a cumulative metrics
        snapshot, when the stage returns (short runs and error exits
        included). Best-effort like every beat; nothing without telemetry
        or a heartbeat channel."""
        if self._heartbeat is None:
            return
        _obs.sample_device_memory(force=True)
        payload = _obs.collect_beat_payload(final=True)
        if payload is None:
            return
        try:
            self._heartbeat.put((self._rank, int(step), time.time(), payload),
                                timeout=2.0)
        except Exception:
            pass


_session: Optional[RayLightningSession] = None


def init_session(rank: int, queue: Optional[Any],
                 heartbeat: Optional[Any] = None,
                 heartbeat_interval: float = 1.0) -> None:
    global _session
    if _session is not None:
        raise ValueError("A session already exists in this process; only one "
                         "training session may be active per worker.")
    _session = RayLightningSession(rank=rank, queue=queue, heartbeat=heartbeat,
                                   heartbeat_interval=heartbeat_interval)


def reset_session() -> None:
    """Allow another trainer entry point in the same worker process."""
    global _session
    _session = None


def get_session() -> RayLightningSession:
    if _session is None:
        raise ValueError("No session found; init_session was not called in "
                         "this process.")
    return _session


def get_actor_rank() -> int:
    return get_session().rank


def put_queue(item: Callable) -> None:
    get_session().put_queue(item)


def heartbeat_enabled() -> bool:
    """Whether this process's session beats to a supervisor."""
    return _session is not None and _session._heartbeat is not None


def flush_telemetry(step: int) -> None:
    """The session's final telemetry beat (a no-op without a session)."""
    if _session is not None:
        _session.flush_telemetry(step)


def emit_done() -> None:
    """The last beat of a worker whose stage has returned: the supervisor
    stops watching it (a no-op without a heartbeat channel)."""
    if _session is not None:
        _session.heartbeat(DONE, force=True)


def emit_heartbeat(step: int, force: bool = False) -> None:
    """The Trainer's tick: a no-op without a session (a Trainer in the main
    process) or without a heartbeat channel."""
    if _session is not None:
        _session.heartbeat(step, force=force)
