"""The per-worker session (``ray_lightning_tpu/session.py``): the worker's
rank and its queue back to the main process. The launcher's wrapping function
calls :func:`init_session` once per trainer entry point in each worker;
``put_queue`` hands the main process a callable (pickled by reference)
that it runs while it waits for the workers.

The JAX session also carries heartbeats for the hang supervisor and
telemetry payloads; neither is ported (ROADMAP.md), so the port's session
has no heartbeat channel.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

# how long a worker waits to deliver an item before it fails with an error
# that names its rank, instead of blocking training
PUT_TIMEOUT = 30.0


class RayLightningSession:
    def __init__(self, rank: int, queue: Optional[Any]):
        self._rank = rank
        self._queue = queue

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


_session: Optional[RayLightningSession] = None


def init_session(rank: int, queue: Optional[Any]) -> None:
    global _session
    if _session is not None:
        raise ValueError("A session already exists in this process; only one "
                         "training session may be active per worker.")
    _session = RayLightningSession(rank=rank, queue=queue)


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
