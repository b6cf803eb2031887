"""Asynchronous input feeding (``ray_lightning_tpu/core/prefetch.py``):
host-side batch assembly off the training thread (:class:`AsyncLoader`)
and an N-deep host-to-device lookahead (:class:`DevicePrefetcher`).

The host pipeline (index -> ``dataset[i]`` -> collate -> numpy) is Python
and numpy work that can overlap the step's launches; the host-to-device
copy can overlap the step's compute. ``AsyncLoader`` moves the first into
background threads feeding a bounded queue; ``DevicePrefetcher`` keeps up to
``depth`` batches' copies issued ahead of the step being trained. On the
card those copies run from pinned memory on a side stream, and the compute
stream waits on an event before it uses a batch, so the host never waits
for the device. Both keep the synchronous loop's semantics: batches arrive
in order, and a batch that fails to assemble or to copy raises at the step
where the inline loop would have raised, after every earlier good batch.

Shutdown is tied to the iterator's lifetime: leaving a ``for`` loop early
closes the generator, which stops the feeder thread, drains the queue,
cancels queued work and joins the pool, so a ``max_steps`` exit leaks no
thread.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Optional

import torch

from ray_lightning_tpu_torch.utils.tree import tree_leaves

__all__ = ["AsyncLoader", "DevicePrefetcher"]

# queue item kinds: a future to resolve, a ready value, a forwarded
# exception, or the end of the epoch
_FUTURE, _VALUE, _ERROR, _END = 0, 1, 2, 3

_THREAD_PREFIX = "rlt-torch-input"


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """A bounded put that gives up once the consumer has gone, so an
    abandoned feeder never blocks on a full queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


class AsyncLoader:
    """Iterate a loader on background threads into a bounded queue.

    Loaders with the split protocol (``_batch_plan()`` yielding index
    chunks and ``_assemble(chunk)`` building one batch, as this package's
    ``DataLoader``) get ``num_workers`` pool threads assembling batches at
    once, kept in plan order because the queue carries the futures in
    submission order. Other iterables are serial, so one feeder thread runs
    the iteration itself. The queue holds ``num_workers * prefetch_factor``
    items; each ``__iter__`` starts fresh threads and stops them when the
    epoch ends or the consumer leaves.
    """

    def __init__(self, loader: Iterable, num_workers: Optional[int] = None,
                 prefetch_factor: Optional[int] = None):
        self.loader = loader
        if num_workers is None:
            num_workers = getattr(loader, "num_workers", None)
        self.num_workers = max(1, int(num_workers)) if num_workers else 1
        if prefetch_factor is None:
            prefetch_factor = getattr(loader, "prefetch_factor", None)
        self.prefetch_factor = max(1, int(prefetch_factor)) if prefetch_factor else 2
        self._q: Optional[queue.Queue] = None

    def qsize(self) -> int:
        """How many batches wait in the queue now (0 outside an epoch)."""
        q = self._q
        return q.qsize() if q is not None else 0

    def set_epoch(self, epoch: int) -> None:
        inner = getattr(self.loader, "set_epoch", None)
        if callable(inner):
            inner(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        plan = getattr(self.loader, "_batch_plan", None)
        assemble = getattr(self.loader, "_assemble", None)
        if callable(plan) and callable(assemble):
            return self._iter_pooled(plan, assemble)
        return self._iter_serial()

    def _iter_pooled(self, plan: Callable, assemble: Callable):
        q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        self._q = q
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                  thread_name_prefix=f"{_THREAD_PREFIX}-pool")

        def feed():
            try:
                for chunk in plan():
                    if stop.is_set():
                        return
                    if not _put(q, (_FUTURE, pool.submit(assemble, chunk)), stop):
                        return
            except BaseException as exc:  # forwarded to the consumer in order
                _put(q, (_ERROR, exc), stop)
            finally:
                _put(q, (_END, None), stop)

        feeder = threading.Thread(target=feed, name=f"{_THREAD_PREFIX}-feed",
                                  daemon=True)
        feeder.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == _END:
                    return
                if kind == _ERROR:
                    raise payload
                yield payload.result()
        finally:
            self._shutdown(q, stop, feeder)
            pool.shutdown(wait=True, cancel_futures=True)

    def _iter_serial(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        self._q = q
        stop = threading.Event()

        def feed():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        return
                    if not _put(q, (_VALUE, batch), stop):
                        return
            except BaseException as exc:  # forwarded to the consumer in order
                _put(q, (_ERROR, exc), stop)
            finally:
                _put(q, (_END, None), stop)

        feeder = threading.Thread(target=feed, name=f"{_THREAD_PREFIX}-feed",
                                  daemon=True)
        feeder.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == _END:
                    return
                if kind == _ERROR:
                    raise payload
                yield payload
        finally:
            self._shutdown(q, stop, feeder)

    def _shutdown(self, q: "queue.Queue", stop: threading.Event, feeder) -> None:
        stop.set()
        self._q = None
        # unblock a feeder stuck on a full queue; cancel queued work
        while True:
            try:
                kind, payload = q.get_nowait()
            except queue.Empty:
                break
            if kind == _FUTURE:
                payload.cancel()
        feeder.join(timeout=10.0)


class DevicePrefetcher:
    """N-deep host-to-device lookahead.

    Up to ``depth`` batches beyond the one being trained have gone through
    ``shard_fn`` (the host-to-device copy) while the caller runs the current
    step; ``depth=0`` is the synchronous path. With a CUDA ``stream``,
    ``shard_fn`` runs on that side stream (its copies should be
    ``non_blocking`` from pinned memory) and an event marks the end of its
    copies; when the batch is yielded, the current stream waits on that
    event and each of its tensors is recorded as used there
    (``record_stream``), so the caching allocator does not hand its memory
    to the side stream's next copy while the step still reads it. No call
    waits on the host.

    Error contract (the synchronous loop's): a batch that fails to load or
    to copy does not swallow the good batches before it; they are yielded
    first, then the exception is raised. ``starved_s`` adds up the time
    the training thread waited on the host loader; with a flight
    ``recorder`` (``observability/trace.py``) it is also the
    ``rlt_input_starved_seconds`` counter, beside the
    ``rlt_prefetch_queue_depth`` gauge and ``host_batch``/``h2d`` spans of
    each batch (``h2d`` times the issue of the copies, not the copies).
    """

    def __init__(self, shard_fn: Callable[[Any], Any], depth: int = 2,
                 stream: Optional["torch.cuda.Stream"] = None,
                 recorder: Any = None):
        self.shard_fn = shard_fn
        self.depth = max(0, int(depth))
        self.stream = stream
        self.recorder = recorder
        self.starved_s = 0.0
        self.batches = 0

    def _issue(self, batch):
        if self.stream is None:
            return self.shard_fn(batch), None
        with torch.cuda.stream(self.stream):
            device_batch = self.shard_fn(batch)
            done = torch.cuda.Event()
            done.record(self.stream)
        return device_batch, done

    def _ready(self, device_batch, done) -> None:
        if done is None:
            return
        compute = torch.cuda.current_stream(self.stream.device)
        compute.wait_event(done)
        for leaf in tree_leaves(device_batch):
            if torch.is_tensor(leaf) and leaf.is_cuda:
                leaf.record_stream(compute)

    def iterate(self, loader: Iterable, limit: Optional[int] = None):
        """Yield ``(idx, host_batch, device_batch)`` with the lookahead."""
        rec = self.recorder
        starved_c = depth_g = None
        if rec is not None:
            from ray_lightning_tpu_torch.observability import metrics

            reg = metrics.get_registry()
            starved_c = reg.counter("rlt_input_starved_seconds")
            depth_g = reg.gauge("rlt_prefetch_queue_depth")
        qsize = getattr(loader, "qsize", None)
        it = iter(loader)
        pending: deque = deque()
        error: Optional[BaseException] = None
        exhausted = False
        next_idx = 0
        try:
            while True:
                # keep the window at depth + 1: the batch to yield now and
                # ``depth`` copies in flight behind it
                while (not exhausted and len(pending) <= self.depth
                       and (limit is None or next_idx < limit)):
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    except BaseException as exc:
                        error = exc
                        exhausted = True
                        break
                    wait = time.perf_counter() - t0
                    self.starved_s += wait
                    if rec is not None:
                        starved_c.inc(wait)
                        rec.add_span("host_batch", time.time() - wait, wait,
                                     step=next_idx)
                        if qsize is not None:
                            depth_g.set(qsize())
                    try:
                        if rec is not None:
                            wall, t1 = time.time(), time.perf_counter()
                            device_batch, done = self._issue(batch)
                            rec.add_span("h2d", wall, time.perf_counter() - t1,
                                         step=next_idx)
                        else:
                            device_batch, done = self._issue(batch)
                    except BaseException as exc:
                        error = exc
                        exhausted = True
                        break
                    pending.append((next_idx, batch, device_batch, done))
                    next_idx += 1
                    self.batches += 1
                if pending:
                    idx, batch, device_batch, done = pending.popleft()
                    self._ready(device_batch, done)
                    yield idx, batch, device_batch
                    continue
                if error is not None:
                    raise error
                return
        finally:
            close = getattr(it, "close", None)
            if callable(close):
                close()
