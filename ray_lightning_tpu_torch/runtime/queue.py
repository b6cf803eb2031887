"""A cross-process queue from workers to the main process
(``ray_lightning_tpu/runtime/queue.py``, its actor-backed ``Queue`` and
``QueueClient``): the role of ``ray.util.queue.Queue``, through which a
worker's session hands the main process callables to run (``session.put_queue``).

Two implementations behind one API (``put``, ``get_all``, ``handle()``,
``shutdown``), as in the JAX package:

- :class:`ShmQueue` (preferred): the native lock-free MPMC ring in shared
  memory (``runtime/native/rlt_shm.cpp``): no server process, no socket
  hop; a payload larger than a slot spills into a native store segment and
  travels by ref (a tune checkpoint's callable does);
- :class:`Queue`: an actor holding a deque; the main process's
  :class:`Queue` and the workers' :class:`QueueClient` (from
  ``Queue.handle()``) talk to it over its socket. Workers on other hosts
  need it.

Every put is bounded by a timeout and names the queue when it fails.
Items are pickled with the standard library, by reference.
:func:`make_queue` picks the ring where it can.
"""
from __future__ import annotations

import collections
import ctypes
import os
import pickle
import queue as _queue_mod
import secrets
import time
from typing import Any, List, Optional

from ray_lightning_tpu_torch import observability as _obs
from ray_lightning_tpu_torch.runtime import api, native
from ray_lightning_tpu_torch.runtime.actor import (
    ActorError,
    ActorHandle,
    ActorTimeout,
    dumps,
)
from ray_lightning_tpu_torch.runtime.object_store import (
    get_object,
    put_detached,
    release,
)
from ray_lightning_tpu_torch.utils.ports import node_ip_address

Full = _queue_mod.Full


def _record_put_wait(impl: str, seconds: float) -> None:
    """Queue back-pressure into ``rlt_queue_put_wait_seconds{impl}``; the
    call sites take the time only with telemetry on."""
    reg = _obs.registry()
    if reg is not None:
        reg.histogram("rlt_queue_put_wait_seconds", impl=impl).observe(seconds)


def _actor_put(actor, item: Any, timeout: Optional[float]) -> None:
    t0 = time.perf_counter() if _obs.enabled() else None
    try:
        ok = actor.call("put", item).result(timeout=timeout)
        if t0 is not None:
            _record_put_wait("actor", time.perf_counter() - t0)
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

    kind = "actor"

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


# --------------------------------------------------------------------- #
# the native ring
# --------------------------------------------------------------------- #
_SPILL_KEY = "__torchrt_spilled_ref__"
_EAGAIN = -11


class _ShmQueueBase:
    kind = "shm"

    def __init__(self, name: str):
        self._name = name
        self._queue = None
        self._base = None
        self._len = None

    @property
    def name(self) -> str:
        return self._name

    def _attach(self):
        lib = native.get_lib()
        if lib is None:
            raise RuntimeError("the shared-memory queue needs librlt_shm, "
                               "which could not be built or loaded here")
        if self._queue is None:
            base, length = ctypes.c_void_p(), ctypes.c_uint64()
            q = lib.rlt_queue_attach(("/" + self._name).encode(),
                                     ctypes.byref(base), ctypes.byref(length))
            if not q:
                raise FileNotFoundError(f"shm queue {self._name} not found")
            self._queue, self._base, self._len = ctypes.c_void_p(q), base, length
        return lib

    def put(self, item: Any, timeout: Optional[float] = 30.0) -> None:
        """Push ``item`` (pickled by reference). A payload larger than a
        slot is spilled into a native store segment and the ring carries
        its ref; the reader frees it. On a full ring, retry until
        ``timeout`` (None: fail at once), then raise :class:`Full` naming
        the queue."""
        lib = self._attach()
        payload = dumps(item, "a queue item")
        slot_bytes = int(lib.rlt_queue_slot_bytes(self._queue))
        spill = None
        if len(payload) > slot_bytes:
            spill = put_detached(payload)
            payload = dumps({_SPILL_KEY: spill}, "a spill ref")
        buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.perf_counter() if _obs.enabled() else None
        while True:
            rc = lib.rlt_queue_push(self._queue, buf, len(payload))
            if rc == 0:
                if t0 is not None:
                    _record_put_wait("shm", time.perf_counter() - t0)
                return
            if rc == _EAGAIN and deadline is not None and (
                    time.monotonic() < deadline):
                time.sleep(0.005)
                continue
            if spill is not None:  # the ref never made it in
                release(spill)
            if rc == _EAGAIN:
                raise Full(f"shm queue {self._name} is full"
                           + (f" (gave up after {timeout}s)" if timeout
                              else "") + "; is the main process draining it?")
            raise RuntimeError(f"rlt_queue_push({self._name}) failed: {rc}")

    def _detach(self) -> None:
        lib = native.get_lib()
        if self._queue is not None and lib is not None:
            lib.rlt_queue_detach(self._base, self._len)
        self._queue = None


class ShmQueueHandle(_ShmQueueBase):
    """A producer's handle: pickles as the ring's name and attaches in the
    process that first puts."""

    def __getstate__(self):
        return {"_name": self._name}

    def __setstate__(self, state):
        self.__init__(state["_name"])


class ShmQueue(_ShmQueueBase):
    """The native lock-free MPMC ring in shared memory: no server process,
    no socket hop. ``capacity`` slots (a power of two) of ``slot_bytes``
    each; larger items travel as a store segment (the JAX package's
    ``ShmQueue``)."""

    def __init__(self, capacity: int = 1024, slot_bytes: int = 16384):
        lib = native.get_lib()
        if lib is None:
            raise RuntimeError("the shared-memory queue needs librlt_shm, "
                               "which could not be built or loaded here")
        name = f"torchrtq_{os.getpid()}_{secrets.token_hex(6)}"
        rc = lib.rlt_queue_create(("/" + name).encode(), capacity, slot_bytes)
        if rc != 0:
            raise RuntimeError(f"rlt_queue_create({name}) failed: {rc}")
        super().__init__(name)
        # (pickled bytes, spilled) of the last items read, newest last
        self.traffic: collections.deque = collections.deque(maxlen=65536)

    def handle(self) -> ShmQueueHandle:
        return ShmQueueHandle(self._name)

    def get_all(self, timeout: Optional[float] = None) -> List[Any]:
        """Every item queued so far, oldest first (never blocks:
        ``timeout`` is taken for the actor queue's signature). Each item's
        pickled size and whether it spilled go into :attr:`traffic`."""
        lib = self._attach()
        slot_bytes = int(lib.rlt_queue_slot_bytes(self._queue))
        out = (ctypes.c_uint8 * slot_bytes)()
        items: List[Any] = []
        while True:
            n = lib.rlt_queue_pop(self._queue, out, slot_bytes)
            if n == _EAGAIN:
                break
            if n < 0:
                raise RuntimeError(f"rlt_queue_pop({self._name}) failed: {n}")
            blob = bytes(out[:n])
            item = pickle.loads(blob)
            spilled = isinstance(item, dict) and _SPILL_KEY in item
            if spilled:
                ref = item[_SPILL_KEY]
                try:
                    blob = get_object(ref)
                    item = pickle.loads(blob)
                finally:
                    release(ref)
            self.traffic.append((len(blob), spilled))
            items.append(item)
        if items:
            reg = _obs.registry()
            if reg is not None:
                reg.counter("rlt_queue_get_items_total", impl="shm").inc(
                    len(items))
        return items

    def empty(self) -> bool:
        return self.qsize() == 0

    def qsize(self) -> int:
        lib = self._attach()
        return int(lib.rlt_queue_size(self._queue))

    def shutdown(self) -> None:
        """Drain (a spilled item holds a segment whose ref lives only in the
        ring), detach and unlink the ring."""
        try:
            self.get_all()
        except Exception:
            pass
        self._detach()
        lib = native.get_lib()
        if lib is not None:
            lib.rlt_queue_unlink(("/" + self._name).encode())


def make_queue(cross_host: bool = False, **kwargs):
    """The ring when the native library builds and the queue stays on one
    host, else the actor queue (shared memory cannot cross machines).
    ``capacity`` and ``slot_bytes`` go to the ring, the rest to the actor
    queue. ``queue.kind`` says which it is: ``"shm"`` or ``"actor"``."""
    shm_kwargs = {k: kwargs.pop(k) for k in ("capacity", "slot_bytes")
                  if k in kwargs}
    if not cross_host and native.available():
        try:
            return ShmQueue(**shm_kwargs)
        except Exception:
            pass
    return Queue(cross_host=cross_host, **kwargs)
