"""A cross-process queue from workers to the main process
(``ray_lightning_tpu/runtime/queue.py``, its actor-backed ``Queue`` and
``QueueClient``): the role of ``ray.util.queue.Queue``, through which a
worker's session hands the main process callables to run (``session.put_queue``).

A queue actor holds a deque; the main process's :class:`Queue` and the workers'
:class:`QueueClient` (from ``Queue.handle()``) talk to it over its socket.
Every put is bounded by a timeout and names the queue when it fails. The
JAX package's native shared-memory ring (``ShmQueue``, ``runtime/native/``)
is not ported: ``ShmQueue`` raises, and ``make_queue`` returns the actor
queue (ROADMAP.md).
"""
from __future__ import annotations

import collections
import queue as _queue_mod
from typing import Any, List, Optional

from ray_lightning_tpu_torch.runtime import api
from ray_lightning_tpu_torch.runtime.actor import (
    ActorError,
    ActorHandle,
    ActorTimeout,
)
from ray_lightning_tpu_torch.utils.ports import node_ip_address

Full = _queue_mod.Full


def _actor_put(actor, item: Any, timeout: Optional[float]) -> None:
    try:
        ok = actor.call("put", item).result(timeout=timeout)
    except ActorTimeout:
        raise Full(f"queue actor {actor.name!r}: put got no reply within "
                   f"{timeout}s (is the main process gone?)") from None
    except ActorError as e:
        raise RuntimeError(f"queue actor {actor.name!r}: put failed: {e}") from e
    if not ok:
        raise Full(f"queue actor {actor.name!r} is full")


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self.items: collections.deque = collections.deque()

    def put(self, item: Any) -> bool:
        if self.maxsize and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def get_nowait_batch(self) -> List[Any]:
        out = list(self.items)
        self.items.clear()
        return out

    def empty(self) -> bool:
        return not self.items


class Queue:
    """The main process's side: creates the queue actor. ``cross_host=True``
    hands out handles that dial this host's routable address, for workers
    on other nodes."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None,
                 cross_host: bool = False, timeout: float = 60.0):
        options = dict(actor_options or {})
        self._actor = api.create_actor(
            _QueueActor, args=(maxsize,), name=options.get("name"),
            num_cpus=options.get("num_cpus", 0), timeout=timeout)
        self._cross_host = cross_host
        self._timeout = timeout

    def handle(self) -> "QueueClient":
        handle = self._actor
        if self._cross_host:
            handle = ActorHandle(handle.name,
                                 (node_ip_address(), handle._address[1]),
                                 handle._authkey, handle._pid)
        return QueueClient(handle)

    def put(self, item: Any, timeout: Optional[float] = 30.0) -> None:
        _actor_put(self._actor, item, timeout)

    def get_all(self, timeout: Optional[float] = None) -> List[Any]:
        """Every item queued so far, oldest first (bounded by ``timeout``,
        the queue's own by default)."""
        return self._actor.call("get_nowait_batch").result(
            timeout=self._timeout if timeout is None else timeout)

    def empty(self) -> bool:
        return self._actor.call("empty").result(timeout=self._timeout)

    def shutdown(self) -> None:
        api.kill(self._actor)


class QueueClient:
    """A worker's side of an actor queue, from a pickled handle."""

    def __init__(self, actor_handle: ActorHandle):
        self._actor = actor_handle

    def put(self, item: Any, timeout: Optional[float] = 30.0) -> None:
        _actor_put(self._actor, item, timeout)


class ShmQueue:
    """The JAX package's native shared-memory queue: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShmQueue: the native shared-memory queue (runtime/native/) is "
            "not ported; see ROADMAP.md. Use runtime.queue.Queue (an actor)")


def make_queue(cross_host: bool = False, **kwargs) -> Queue:
    """The actor queue (the JAX package would prefer its native ring)."""
    kwargs.pop("capacity", None)
    kwargs.pop("slot_bytes", None)
    return Queue(cross_host=cross_host, **kwargs)
