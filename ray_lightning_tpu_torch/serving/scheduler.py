"""Continuous-batching scheduler: bounded admission queue -> KV slots
(``ray_lightning_tpu/serving/scheduler.py``).

Pure host logic. Each engine iteration calls
:meth:`ContinuousBatchScheduler.tick`, which returns a :class:`Plan`:

- ``prefills`` — up to ``max_prefills_per_tick`` queued requests paired
  with the slots they were just admitted into (each prefill stalls every
  running stream for one iteration, so the bound caps that stall);
- ``decode_slots`` — every occupied slot, the just-admitted ones included:
  their first decode yields their first token in the same iteration.

Admission is FIFO from a bounded queue (a full queue raises
:class:`RequestQueueFull` at submit). Expired requests are swept out
before admission and reported through ``on_evict``. A head the pool
refuses blocks the queue (strict FIFO) unless ``head_skip_limit`` opens a
bounded skip-ahead window, which ``head_aging_ticks`` closes again once
the head has waited that many ticks.

Multi-tenant QoS (:meth:`ContinuousBatchScheduler.configure_tenants`): a
:class:`~.tenancy.TenantRegistry` replaces the one FIFO by a FIFO per
tenant and admits across them by deficit round robin (DRR): a rotation
pointer walks the active tenants, each earns ``weight`` credit when its
turn comes and spends one a admission, so admissions under saturation
converge to the weight ratio. The skip-ahead window and its aging run per
tenant queue, against that queue's own head. With no registry the single
FIFO path runs, unchanged.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch import observability as _obs
from ray_lightning_tpu_torch.observability import metrics as _metrics
from ray_lightning_tpu_torch.serving.kv_pool import Slot


class RequestQueueFull(RuntimeError):
    """The admission queue is at capacity — shed load or retry later."""


@dataclass
class Request:
    """One generation request (token ids in, token ids out)."""

    request_id: str
    tokens: Tuple[int, ...]
    max_new_tokens: int
    eos_id: Optional[int] = None
    on_token: Optional[Callable[[str, int], Any]] = None
    # absolute deadline (perf_counter domain); None = no TTL
    deadline: Optional[float] = None
    # 0 = highest; the shed policy drops priority >= 1 first
    priority: int = 0
    # the journal's attempt number (0 = the first submission)
    retries: int = 0
    # ticks this request spent as a deferred queue head (aging signal)
    deferred_ticks: int = 0
    # the request's trace (observability/reqtrace.RequestTrace), minted at
    # engine submit; None with telemetry off or when sampling dropped it
    trace: Optional[Any] = None
    # the submitting tenant; None = classless traffic (the default DRR
    # queue once tenancy is configured)
    tenant: Optional[str] = None

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


@dataclass
class Plan:
    """What one engine iteration executes."""

    prefills: List[Tuple[Request, Slot]]
    decode_slots: List[Slot]

    @property
    def has_work(self) -> bool:
        return bool(self.prefills or self.decode_slots)


class ContinuousBatchScheduler:
    """FIFO admission from a bounded queue into the KV pool."""

    def __init__(self, pool, max_queue: int = 256,
                 max_prefills_per_tick: int = 1, head_skip_limit: int = 0,
                 head_aging_ticks: int = 16):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_prefills_per_tick < 1:
            raise ValueError(
                "max_prefills_per_tick must be >= 1, got "
                f"{max_prefills_per_tick}"
            )
        if head_skip_limit < 0:
            raise ValueError(
                f"head_skip_limit must be >= 0, got {head_skip_limit}"
            )
        if head_aging_ticks < 1:
            raise ValueError(
                f"head_aging_ticks must be >= 1, got {head_aging_ticks}"
            )
        self.pool = pool
        self.max_queue = int(max_queue)
        self.max_prefills_per_tick = int(max_prefills_per_tick)
        self.head_skip_limit = int(head_skip_limit)
        self.head_aging_ticks = int(head_aging_ticks)
        self._queue: Deque[Request] = deque()
        self._lock = threading.Lock()
        self.queued_total = 0
        self.rejected_total = 0
        self.deferred_total = 0  # ticks the queue head waited for capacity
        self.expired_total = 0  # queued requests swept past their deadline
        self.skipped_total = 0  # admissions that jumped a deferred head
        # engine hook: called (outside the lock) with each queued Request
        # swept past its deadline
        self.on_evict: Optional[Callable[[Request], Any]] = None
        # multi-tenant QoS (None = the single-queue path)
        self._tenancy: Optional[Any] = None
        self._tqueues: Dict[str, Deque[Request]] = {}
        self._deficit: Dict[str, float] = {}
        self._order: Deque[str] = deque()  # DRR rotation of active tenants
        self._in_order: set = set()
        self.admitted_by_tenant: Dict[str, int] = {}

    # ------------------------------------------------------------------ #
    # multi-tenant QoS
    # ------------------------------------------------------------------ #
    def configure_tenants(self, registry: Any) -> None:
        """Install a :class:`~.tenancy.TenantRegistry` and admit by DRR over
        per-tenant queues. Requests already queued move to their tenants'
        queues in FIFO order. ``None`` is a no-op."""
        if registry is None:
            return
        with self._lock:
            self._tenancy = registry
            backlog = list(self._queue)
            self._queue.clear()
            for req in backlog:
                self._tenant_enqueue(req)

    @staticmethod
    def _tenant_key(req: Request) -> str:
        return req.tenant or ""

    def _tenant_enqueue(self, req: Request) -> None:
        """Append to the request's tenant queue (lock held)."""
        key = self._tenant_key(req)
        q = self._tqueues.get(key)
        if q is None:
            q = self._tqueues[key] = deque()
        q.append(req)
        if key not in self._in_order:
            self._order.append(key)
            self._in_order.add(key)

    def _retire_tenant(self, key: str) -> None:
        """Drop a drained tenant from the rotation (lock held): an emptied
        queue forfeits its residual credit, so an idle tenant cannot bank
        credit for a later burst."""
        self._deficit.pop(key, None)
        self._in_order.discard(key)
        try:
            self._order.remove(key)
        except ValueError:
            pass

    def tenant_depths(self) -> Dict[str, int]:
        """Queue depth per tenant key ("" = classless); empty without
        tenancy."""
        with self._lock:
            return {k: len(q) for k, q in self._tqueues.items()}

    def submit(self, request: Request) -> None:
        """Enqueue or raise :class:`RequestQueueFull` (bounded queue)."""
        if request.prompt_len + request.max_new_tokens > self.pool.max_len:
            raise ValueError(
                f"request {request.request_id!r}: {request.prompt_len} "
                f"prompt + {request.max_new_tokens} new tokens exceed the "
                f"pool's max_len={self.pool.max_len}"
            )
        with self._lock:
            if self._depth_locked() >= self.max_queue:
                self.rejected_total += 1
                raise RequestQueueFull(
                    f"admission queue is full ({self.max_queue} waiting); "
                    "add replicas, raise max_queue, or retry with backoff"
                )
            if self._tenancy is not None:
                self._tenant_enqueue(request)
            else:
                self._queue.append(request)
            self.queued_total += 1
            depth = self._depth_locked()
        self._publish_depth(depth)

    def _depth_locked(self) -> int:
        if self._tenancy is not None:
            return sum(len(q) for q in self._tqueues.values())
        return len(self._queue)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._depth_locked()

    def tick(self) -> Plan:
        """Admit queued requests into free capacity (bounded per tick) and
        return the iteration plan. Admission is peek-then-acquire: the pool
        may refuse the head (no free slot, or not enough KV blocks for the
        prompt plus its worst-case growth)."""
        if self._tenancy is not None:
            return self._tick_drr()
        prefills: List[Tuple[Request, Slot]] = []
        expired: List[Request] = []
        with self._lock:
            if any(r.deadline is not None for r in self._queue):
                now = time.perf_counter()
                kept: Deque[Request] = deque()
                for req in self._queue:
                    if req.deadline is not None and now > req.deadline:
                        expired.append(req)
                        self.expired_total += 1
                    else:
                        kept.append(req)
                self._queue = kept
            i = 0
            while (i < len(self._queue)
                   and len(prefills) < self.max_prefills_per_tick):
                req = self._queue[i]
                # aging bound: an over-deferred head closes the window
                if i > 0 and (
                    self._queue[0].deferred_ticks > self.head_aging_ticks
                ):
                    break
                slot = self.pool.acquire(
                    req.request_id, req.prompt_len, req.max_new_tokens,
                    eos_id=req.eos_id, prompt_tokens=req.tokens,
                    deadline=req.deadline,
                )
                if slot is None:  # back-pressure: keep the request queued
                    if i == 0:
                        req.deferred_ticks += 1
                        self.deferred_total += 1
                        if req.trace is not None:
                            req.trace.deferred()
                        if self.head_skip_limit == 0:
                            break
                    i += 1
                    if i > self.head_skip_limit:
                        break
                    continue
                del self._queue[i]
                if i > 0:
                    self.skipped_total += 1
                if req.trace is not None:
                    req.trace.admitted(slot.index)
                    slot.trace = req.trace
                prefills.append((req, slot))
                # do not advance i: the next element shifted into place
            depth = len(self._queue)
        self._publish_depth(depth)
        if expired and self.on_evict is not None:
            for req in expired:
                self.on_evict(req)
        return Plan(prefills=prefills, decode_slots=self.pool.active_slots())

    def _tick_drr(self) -> Plan:
        """The tick with tenancy: the deadline sweep over every tenant
        queue, then deficit-round-robin admission. The pointer stays on a
        tenant until its credit is spent, its queue drains or the pool
        refuses its head; a refusal keeps the pointer and the credit for
        the next tick (moving on would hand every tick's capacity to
        whoever sorts first, and the weights would collapse to round
        robin). Credit is capped at ``max(weight, 1) + max_prefills``."""
        prefills: List[Tuple[Request, Slot]] = []
        expired: List[Request] = []
        with self._lock:
            for key, q in self._tqueues.items():
                if not any(r.deadline is not None for r in q):
                    continue
                now = time.perf_counter()
                kept: Deque[Request] = deque()
                for req in q:
                    if req.deadline is not None and now > req.deadline:
                        expired.append(req)
                        self.expired_total += 1
                    else:
                        kept.append(req)
                self._tqueues[key] = kept
            while self._order and len(prefills) < self.max_prefills_per_tick:
                key = self._order[0]
                q = self._tqueues.get(key)
                if not q:
                    self._retire_tenant(key)
                    continue
                if self._deficit.get(key, 0.0) < 1.0:
                    weight = float(self._tenancy.weight(key or None))
                    cap = max(weight, 1.0) + float(self.max_prefills_per_tick)
                    self._deficit[key] = min(
                        self._deficit.get(key, 0.0) + weight, cap)
                if self._admit_tenant(key, q, prefills):
                    break  # the pool refused: pointer and credit stay
                if not q:
                    self._retire_tenant(key)
                elif self._deficit.get(key, 0.0) < 1.0:
                    self._order.rotate(-1)  # credit spent: next tenant
                # else: the tick's prefill budget is spent with credit left
            depth = self._depth_locked()
            tenant_depths = {k: len(q) for k, q in self._tqueues.items()}
        self._publish_depth(depth, tenant_depths)
        if expired and self.on_evict is not None:
            for req in expired:
                self.on_evict(req)
        return Plan(prefills=prefills, decode_slots=self.pool.active_slots())

    def _admit_tenant(self, key: str, q: Deque[Request],
                      prefills: List[Tuple[Request, Slot]]) -> bool:
        """Admit from one tenant queue while credit and the tick's budget
        last (lock held). Returns True when the pool refused the queue's
        head (a deferral charged to this tenant's head alone)."""
        i = 0
        while (i < len(q) and len(prefills) < self.max_prefills_per_tick
               and self._deficit.get(key, 0.0) >= 1.0):
            req = q[i]
            # per-tenant aging: an over-deferred head closes this tenant's
            # skip-ahead window; other tenants are unaffected
            if i > 0 and q[0].deferred_ticks > self.head_aging_ticks:
                return True
            slot = self.pool.acquire(
                req.request_id, req.prompt_len, req.max_new_tokens,
                eos_id=req.eos_id, prompt_tokens=req.tokens,
                deadline=req.deadline,
            )
            if slot is None:
                if i == 0:
                    req.deferred_ticks += 1
                    self.deferred_total += 1
                    if req.trace is not None:
                        req.trace.deferred()
                    if self.head_skip_limit == 0:
                        return True
                i += 1
                if i > self.head_skip_limit:
                    return True
                continue
            del q[i]
            if i > 0:
                self.skipped_total += 1
            if req.trace is not None:
                req.trace.admitted(slot.index)
                slot.trace = req.trace
            prefills.append((req, slot))
            self._deficit[key] = self._deficit.get(key, 0.0) - 1.0
            self.admitted_by_tenant[key] = (
                self.admitted_by_tenant.get(key, 0) + 1)
        # scanned off the end with requests still queued: the pool refused
        # everything reachable, a block as on the head paths
        return len(q) > 0 and i >= len(q)

    def has_work(self) -> bool:
        with self._lock:
            queued = bool(self._queue) or any(self._tqueues.values())
        return queued or self.pool.occupancy > 0

    def drain_queue(self) -> List[Request]:
        """Remove and return every queued (not yet admitted) request."""
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
            for key in list(self._tqueues):
                out.extend(self._tqueues[key])
                self._tqueues[key].clear()
                self._retire_tenant(key)
        self._publish_depth(0)
        return out

    def _publish_depth(self, depth: int,
                       tenant_depths: Optional[Dict[str, int]] = None) -> None:
        reg = _obs.registry()
        if reg is not None:
            reg.gauge("rlt_serve_queue_depth").set(depth)
            if tenant_depths:
                for key, tdepth in tenant_depths.items():
                    label = reg.tenant_label(key or "default")
                    reg.gauge(
                        _metrics.TENANT_QUEUE_DEPTH_METRIC, tenant=label
                    ).set(tdepth)
