"""The serving fleet (``ray_lightning_tpu/serving/replica.py``): many
engines behind one front door.

- :class:`LocalReplicaFleet`: in-process engines, one loop thread each, all
  on one device and one params dict. Every request is a
  :class:`~.resilience.RequestJournal` entry, so it survives its replica: a
  recovery pump settles finished attempts (feeding each replica's
  :class:`~.resilience.CircuitBreaker`), relaunches dead engines under
  their own index and redispatches ``prompt + delivered``. With
  ``prefill_replicas > 0`` the fleet is disaggregated: the prefill pool
  parks each prefilled request and the pump ships its KV to a decode
  replica (send, verify, admit; retries with backoff, then the colocated
  fallback), serially, as the JAX package's pump does.
- :class:`ReplicaGroup`: one :class:`ServeReplicaActor` (an engine in its
  own process) per replica, launched through the runtime's
  ``create_actors``. Replicas publish ``(index, decode_steps, wall, {"load":
  ...})`` beats into a runtime queue, and a monitor-mode
  :class:`~ray_lightning_tpu_torch.runtime.supervisor.Supervisor` pumps
  them into a :class:`_LoadTap` that the router reads. :meth:`ReplicaGroup.
  check` relaunches a dead or silent replica alone; the others keep
  serving.
- :class:`Autoscaler`: drives either fleet from its own load reports, with
  hysteresis (cooldown, consecutive idle ticks) and an explicit
  ``capacity_blocked`` outcome; :func:`autoscale_decision`,
  :func:`pick_least_loaded` and :func:`needs_relaunch` are the pure policy.

An actor executes its calls on one thread, in order, so the actor surface
is non-blocking: ``submit`` returns at once (the engine's loop does the
work) and ``poll`` reports completion.

Telemetry (``observability.enable()``): the fleet mints each attempt's
:class:`~ray_lightning_tpu_torch.observability.reqtrace.TraceContext` at
dispatch, so that every hop's request record knows its parent, and
publishes the replica-count gauge, the breakers' states, the migration
counters and transfer histogram, the capacity-blocked, retry and expiry
counters and the ``req/route``, ``serve/replica_dead`` and migration events;
:meth:`LocalReplicaFleet.drain_request_records` drains every live engine's
records. ``ServeReplicaActor(telemetry=True)`` enables telemetry in its
process and beats its metric deltas, trace events and ``"r"`` request
records beside the load; the group's :class:`_LoadTap` keeps only the load,
as the JAX package's does. An actor's builder is pickled by reference: a
module-level function, or a ``functools.partial`` of one.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_lightning_tpu_torch import observability as _obs
from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.observability import metrics as _metrics
from ray_lightning_tpu_torch.observability import reqtrace as _reqtrace
from ray_lightning_tpu_torch.runtime import faults as _faults
from ray_lightning_tpu_torch.serving import migration as _migration
from ray_lightning_tpu_torch.serving.resilience import (
    BREAKER_CLOSED,
    CircuitBreaker,
    JournalEntry,
    RequestJournal,
    RequestShed,
    publish_breaker_states,
)

__all__ = [
    "Autoscaler",
    "CapacityBlocked",
    "LocalReplicaFleet",
    "ReplicaGroup",
    "ServeFuture",
    "ServeReplicaActor",
    "autoscale_decision",
    "needs_relaunch",
    "pick_least_loaded",
]

# the migration transfer-time histogram's bounds (milliseconds)
_TRANSFER_MS_BOUNDS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 5000.0,
)


class CapacityBlocked(RuntimeError):
    """``add_replica`` refused: the fleet is at its device capacity.

    A scale-up verdict the fleet cannot satisfy is a capacity problem, not
    a load problem: the :class:`Autoscaler` reports it as an explicit
    ``capacity_blocked`` outcome (a counter and a streak) instead of
    retrying it silently every tick."""


# --------------------------------------------------------------------- #
# the pure routing, scaling and health policy
# --------------------------------------------------------------------- #
def pick_least_loaded(
    loads: Dict[int, Dict[str, float]],
    num_replicas: int,
    rr_counter: int,
    indices: Optional[Sequence[int]] = None,
    role: Optional[str] = None,
) -> int:
    """A replica index of least ``queue_depth + active``; a replica with no
    load report yet counts as load 0. Ties break round-robin on
    ``rr_counter``.

    ``indices`` restricts routing to an explicit (sparse) set of indices;
    the default is ``range(num_replicas)``. ``role`` restricts it to one
    disaggregated pool: replicas whose report carries that role or
    ``"both"`` (a replica with no report is excluded); ``None`` skips the
    filter."""
    if indices is None:
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        indices = range(num_replicas)
    else:
        indices = list(indices)
        if not indices:
            raise ValueError("no routable replicas")
    if role is not None:
        indices = [
            i for i in indices
            if (loads.get(i) or {}).get("role") in (role, "both")
        ]
        if not indices:
            raise ValueError(f"no routable replicas in the {role!r} pool")

    def load_of(i: int) -> float:
        entry = loads.get(i) or {}
        return float(entry.get("queue_depth", 0)) + float(entry.get("active", 0))

    best = min(load_of(i) for i in indices)
    candidates = [i for i in indices if load_of(i) == best]
    return candidates[rr_counter % len(candidates)]


def autoscale_decision(
    loads: Dict[int, Dict[str, float]],
    num_replicas: int,
    min_replicas: int,
    max_replicas: int,
    queue_high: float = 4.0,
    ttft_high_ms: Optional[float] = None,
    slo_breached: bool = False,
    itl_high_ms: Optional[float] = None,
    role: Optional[str] = None,
    ttft_component_s: Optional[float] = None,
    ttft_component_high_s: Optional[float] = None,
) -> int:
    """The stateless scaling verdict: +1, -1 or 0.

    Up (below ``max_replicas``) when an SLO breach fires, when the mean
    queue depth a replica passes ``queue_high``, when some replica's TTFT
    p95 passes ``ttft_high_ms`` or its inter-token p99 ``itl_high_ms``, or
    when the pool's TTFT component passes ``ttft_component_high_s``. Down
    (above ``min_replicas``) only when nothing is queued or active anywhere
    and no SLO burns. ``role`` scopes the reports to one pool (and
    ``num_replicas`` is then that pool's size). Hysteresis is the
    :class:`Autoscaler`'s."""
    if min_replicas < 1:
        raise ValueError("min_replicas must be >= 1")
    if max_replicas < min_replicas:
        raise ValueError("max_replicas must be >= min_replicas")
    entries = [e or {} for e in loads.values()]
    if role is not None:
        entries = [e for e in entries if e.get("role") in (role, "both")]
    total_queued = sum(float(e.get("queue_depth", 0)) for e in entries)
    total_active = sum(float(e.get("active", 0)) for e in entries)
    worst_ttft = max(
        (float(e.get("ttft_p95_ms", 0.0)) for e in entries), default=0.0
    )
    worst_itl = max(
        (float(e.get("itl_p99_ms", 0.0)) for e in entries), default=0.0
    )
    if num_replicas < max_replicas:
        if slo_breached:
            return 1
        if total_queued / max(num_replicas, 1) > queue_high:
            return 1
        if ttft_high_ms is not None and worst_ttft > ttft_high_ms:
            return 1
        if itl_high_ms is not None and worst_itl > itl_high_ms:
            return 1
        if (
            ttft_component_s is not None
            and ttft_component_high_s is not None
            and ttft_component_s > ttft_component_high_s
        ):
            return 1
    if (
        num_replicas > min_replicas
        and not slo_breached
        and total_queued == 0
        and total_active == 0
    ):
        return -1
    return 0


class Autoscaler:
    """Drives an elastic fleet from its own load reports.

    ``fleet`` is a duck type: ``num_replicas``, ``loads()``,
    ``add_replica()`` and ``remove_replica()`` (with a ``role`` keyword
    when the scaler is scoped to a pool). :class:`LocalReplicaFleet` and
    :class:`ReplicaGroup` are both. The verdict is
    :func:`autoscale_decision`'s; this class adds the hysteresis: at most
    one replica of change a :meth:`tick`, ``cooldown_s`` between two
    actions, and ``idle_ticks_down`` consecutive idle verdicts before a
    drain. ``slo_monitor``, when given, is evaluated over the process's
    metrics registry each tick, and its ``breached()`` forces a scale-up
    and vetoes a drain; with ``ttft_component_high_s`` the pool's mean TTFT
    component since the last tick (``rlt_serve_ttft_component_seconds``)
    is a scale-up signal. With telemetry on, each tick publishes the
    ``rlt_serve_replicas`` gauge, and a capacity-blocked scale-up its
    counter and a ``serve_capacity_blocked`` event."""

    # which lineage TTFT component charges a pool
    POOL_COMPONENT = {"prefill": "queue_wait", "decode": "decode"}

    def __init__(
        self,
        fleet: Any,
        min_replicas: int = 1,
        max_replicas: int = 4,
        queue_high: float = 4.0,
        ttft_high_ms: Optional[float] = None,
        cooldown_s: float = 0.0,
        idle_ticks_down: int = 2,
        slo_monitor: Optional[Any] = None,
        itl_high_ms: Optional[float] = None,
        role: Optional[str] = None,
        ttft_component_high_s: Optional[float] = None,
    ):
        if idle_ticks_down < 1:
            raise ValueError("idle_ticks_down must be >= 1")
        self.fleet = fleet
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = float(queue_high)
        self.ttft_high_ms = ttft_high_ms
        self.itl_high_ms = itl_high_ms
        self.role = role
        self.ttft_component_high_s = ttft_component_high_s
        self._component_prev = (0.0, 0.0)  # (sum, count) at the last tick
        self.cooldown_s = float(cooldown_s)
        self.idle_ticks_down = int(idle_ticks_down)
        self.slo_monitor = slo_monitor
        self._last_action_at: Optional[float] = None
        self._idle_streak = 0
        self.scale_ups = 0
        self.scale_downs = 0
        # scale-up verdicts the fleet could not satisfy; the streak resets
        # on a successful add and whenever the verdict stops asking for
        # more capacity
        self.capacity_blocked_total = 0
        self.capacity_blocked_streak = 0
        self.last_outcome: Optional[str] = None
        self.history: List[Tuple[float, int, int]] = []  # (t, n, delta)

    def _component_signal(self, reg: Any) -> Optional[float]:
        """The mean of this pool's TTFT component over the requests finished
        since the last call, from the cumulative histograms of a metrics
        registry (``reg.items()`` of ``((name, labels), metric)`` with
        ``metric.sum`` and ``metric.count``). None when disabled, without a
        registry, or with no new samples."""
        if reg is None or self.ttft_component_high_s is None:
            return None
        comp = self.POOL_COMPONENT.get(self.role or "")
        if comp is None:
            return None
        total_sum, total_count = 0.0, 0.0
        for (name, labels), metric in reg.items():
            if name != _metrics.SERVE_TTFT_COMPONENT_METRIC:
                continue
            if dict(labels).get("component") != comp:
                continue
            total_sum += float(metric.sum)
            total_count += float(metric.count)
        prev_sum, prev_count = self._component_prev
        self._component_prev = (total_sum, total_count)
        d_sum = total_sum - prev_sum
        d_count = total_count - prev_count
        if d_count <= 0:
            return None
        return d_sum / d_count

    def tick(self, now: Optional[float] = None) -> int:
        """Evaluate once; returns the applied delta (-1, 0, +1)."""
        now = time.monotonic() if now is None else now
        loads = self.fleet.loads()
        if self.role is None:
            n = int(self.fleet.num_replicas)
        else:
            # the pool's size: replicas reporting membership in it
            n = sum(
                1 for e in loads.values()
                if (e or {}).get("role") in (self.role, "both")
            )
        slo_breached = False
        if self.slo_monitor is not None:
            self.slo_monitor.evaluate(reg=_obs.registry())
            slo_breached = self.slo_monitor.breached()
        delta = autoscale_decision(
            loads,
            n,
            self.min_replicas,
            self.max_replicas,
            queue_high=self.queue_high,
            ttft_high_ms=self.ttft_high_ms,
            slo_breached=slo_breached,
            itl_high_ms=self.itl_high_ms,
            role=self.role,
            ttft_component_s=self._component_signal(_obs.registry()),
            ttft_component_high_s=self.ttft_component_high_s,
        )
        if delta <= 0:
            # the pressure is gone: a stale streak would ask for capacity
            # serving no longer needs
            self.capacity_blocked_streak = 0
        if delta < 0:
            self._idle_streak += 1
            if self._idle_streak < self.idle_ticks_down:
                delta = 0
        else:
            self._idle_streak = 0
        if delta != 0 and self._last_action_at is not None:
            if now - self._last_action_at < self.cooldown_s:
                delta = 0
        if delta > 0:
            try:
                if self.role is None:
                    self.fleet.add_replica()
                else:
                    self.fleet.add_replica(role=self.role)
            except CapacityBlocked as exc:
                self.capacity_blocked_total += 1
                self.capacity_blocked_streak += 1
                self.last_outcome = "capacity_blocked"
                reg = _obs.registry()
                if reg is not None:
                    reg.counter(_metrics.SERVE_CAPACITY_BLOCKED_METRIC).inc()
                _obs.event(
                    "serve_capacity_blocked",
                    replicas=n,
                    streak=self.capacity_blocked_streak,
                    error=str(exc),
                )
                delta = 0
            else:
                self.scale_ups += 1
                self.capacity_blocked_streak = 0
                self.last_outcome = "scale_up"
        elif delta < 0:
            if self.role is None:
                self.fleet.remove_replica()
            else:
                self.fleet.remove_replica(role=self.role)
            self.scale_downs += 1
            self._idle_streak = 0
            self.last_outcome = "scale_down"
        if delta != 0:
            self._last_action_at = now
            self.history.append((now, int(self.fleet.num_replicas), delta))
        reg = _obs.registry()
        if reg is not None:
            reg.gauge("rlt_serve_replicas").set(
                int(self.fleet.num_replicas)
            )
        return delta


def needs_relaunch(
    last_beat: Optional[float],
    started: float,
    now: float,
    hang_timeout: Optional[float],
    startup_timeout: Optional[float] = None,
) -> bool:
    """A replica's relaunch verdict from its beat ages (monotonic seconds):
    silence before the first beat is tolerated unless ``startup_timeout``
    bounds it, then silence past ``hang_timeout`` condemns it;
    ``hang_timeout=None`` condemns nothing."""
    if hang_timeout is None:
        return False
    if last_beat is None:
        return (
            startup_timeout is not None and now - started > startup_timeout
        )
    return now - last_beat > hang_timeout


class _LoadTap:
    """The aggregator the group's Supervisor feeds: keeps each replica's
    latest load report (for the router), its beat age and the events."""

    def __init__(self):
        self._lock = threading.Lock()
        self.loads: Dict[int, Dict[str, float]] = {}
        self.ages: Dict[int, float] = {}
        self.events: List[Tuple[str, dict]] = []

    def on_beat(self, rank, step, wall_time, payload) -> None:
        if isinstance(payload, dict) and "load" in payload:
            with self._lock:
                self.loads[int(rank)] = dict(payload["load"])

    def heartbeat_age(self, rank, age) -> None:
        with self._lock:
            self.ages[int(rank)] = float(age)

    def record_event(self, kind, **fields) -> None:
        with self._lock:
            self.events.append((kind, fields))

    def snapshot(self) -> Dict[int, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self.loads.items()}


class _Migration:
    """The pump's state of one prefill -> decode KV migration, keyed by the
    source attempt's rid. The shipment is exported once and reused by every
    retry (a corrupt delivery is simulated on a copy); ``tried`` holds the
    decode replicas already attempted."""

    __slots__ = (
        "entry", "source", "source_rid", "source_completion",
        "shipment", "attempts", "next_at", "tried",
    )

    def __init__(self, entry, source, source_rid, source_completion):
        self.entry = entry
        self.source = int(source)
        self.source_rid = source_rid
        self.source_completion = source_completion
        self.shipment = None
        self.attempts = 0
        self.next_at = 0.0
        self.tried: set = set()


# --------------------------------------------------------------------- #
# the in-process fleet
# --------------------------------------------------------------------- #
class LocalReplicaFleet:
    """An elastic, self-healing fleet of in-process engines, one loop thread
    each, on one ``device`` (the card unless ``device="cpu"``).

    ``builder()`` returns ``(params, cfg)``; it is called once and every
    replica shares the result (the params must live on ``device``).
    ``engine_kwargs`` are the :class:`~.engine.EngineConfig` fields.
    Every submission is a :class:`~.resilience.JournalEntry`, a
    Completion-compatible handle that outlives replica deaths:

    - a replica that dies mid-stream fails the attempt, not the request:
      the pump resubmits ``prompt + delivered`` elsewhere with the remaining
      budget (greedy streams continue token-identically). Size
      ``max_prompt_len`` for the resume: ``prompt_len + max_new_tokens -
      1`` must fit for a request to be resumable at any point;
    - each replica index owns a :class:`~.resilience.CircuitBreaker` that
      survives a relaunch under the index;
    - dead engines are discarded and, with ``relaunch``, rebuilt under the
      same index;
    - :meth:`preempt_replica` and :meth:`remove_replica` drain gracefully:
      the queued backlog is handed back and migrates, in-flight work
      finishes.

    The pump runs on a thread every ``pump_interval_s``; tests call
    :meth:`pump_once` for deterministic stepping. ``capacity`` bounds the
    replicas a scale-up may reach (``CapacityBlocked``); ``tenants`` is a
    :class:`~.tenancy.TenantRegistry` whose quota the fleet charges at
    submit (its engines run with admission off)."""

    def __init__(
        self,
        builder: Callable[[], Tuple[Any, Any]],
        engine_kwargs: Optional[Dict[str, Any]] = None,
        initial_replicas: int = 1,
        max_retries: int = 2,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 5.0,
        relaunch: bool = True,
        drain_timeout: float = 60.0,
        pump_interval_s: float = 0.02,
        capacity: Optional[int] = None,
        prefill_replicas: int = 0,
        migration_policy: Optional[_migration.MigrationPolicy] = None,
        tenants: Optional[Any] = None,
        device: DeviceLike = None,
    ):
        if capacity is not None and capacity < 1:
            raise ValueError("capacity must be >= 1 (or None)")
        self.capacity = capacity
        self.device = resolve_device(device)
        self._builder = builder
        self._engine_kwargs = dict(engine_kwargs or {})
        self._params_cfg: Optional[Tuple[Any, Any]] = None
        self._replicas: Dict[int, Any] = {}  # routable engines
        self._draining: Dict[int, Any] = {}  # engines finishing in-flight
        self._drain_threads: List[threading.Thread] = []
        self._next_index = 0
        self._rr = 0
        self._lock = threading.Lock()
        self.added_total = 0
        self.removed_total = 0
        self.max_retries = int(max_retries)
        self.relaunch = bool(relaunch)
        self.drain_timeout = float(drain_timeout)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.journal = RequestJournal()
        self._tenants = tenants
        self.breakers: Dict[int, CircuitBreaker] = {}
        self.routed_total: Dict[int, int] = {}
        self.relaunches_total = 0
        self._pending: List[JournalEntry] = []
        self._pump_interval = max(float(pump_interval_s), 0.005)
        self._pump_gate = threading.Lock()
        self._pump_stop = threading.Event()
        # an aggregator that records replica deaths (attach_aggregator)
        self._aggregator: Optional[Any] = None
        # disaggregation: the first prefill_replicas initial replicas form
        # the prefill pool, the rest the decode pool; 0 keeps every engine
        # role "both"
        pf = int(prefill_replicas)
        if pf < 0:
            raise ValueError("prefill_replicas must be >= 0")
        if pf and pf >= int(initial_replicas):
            raise ValueError(
                f"prefill_replicas ({pf}) must leave at least one decode "
                f"replica (initial_replicas={initial_replicas})"
            )
        if pf and self._engine_kwargs.get("kv_layout") != "paged":
            raise ValueError(
                "disaggregated serving ships paged KV block chains: set "
                "engine_kwargs kv_layout='paged'"
            )
        self.disaggregated = pf > 0
        self.migration_policy = migration_policy or _migration.MigrationPolicy()
        self.migration_stats = _migration.MigrationStats()
        self.roles: Dict[int, str] = {}
        self._migrations: Dict[str, _Migration] = {}  # source rid -> state
        self._ship_seq: Dict[int, int] = {}  # source index -> shipments sent
        # warm-chain affinity: first-block key -> the prefill replica whose
        # prefix cache holds it (bounded, best effort)
        self._affinity: Dict[bytes, int] = {}
        self._affinity_bs = int(self._engine_kwargs.get("block_size", 16))
        for k in range(int(initial_replicas)):
            if self.disaggregated:
                self.add_replica(role="prefill" if k < pf else "decode")
            else:
                self.add_replica()
        self._pump_thread = threading.Thread(
            target=self._pump_loop, daemon=True, name="rlt-torch-fleet-pump"
        )
        self._pump_thread.start()

    # ---------------- the fleet surface (Autoscaler's duck type) ------- #
    @property
    def num_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def loads(self) -> Dict[int, Dict[str, float]]:
        with self._lock:
            replicas = dict(self._replicas)
        return {i: eng.load() for i, eng in replicas.items()}

    def grant_capacity(self, n: int = 1) -> None:
        """Raise the device capacity by ``n``; no-op when unbounded."""
        if self.capacity is not None:
            self.capacity += int(n)

    def revoke_capacity(self, n: int = 1) -> None:
        """Lower the device capacity by ``n``, never below 1; no-op when
        unbounded."""
        if self.capacity is not None:
            self.capacity = max(1, self.capacity - int(n))

    def _breaker(self, index: int) -> CircuitBreaker:
        with self._lock:
            breaker = self.breakers.get(index)
            if breaker is None:
                breaker = CircuitBreaker(
                    failure_threshold=self.breaker_threshold,
                    open_cooldown_s=self.breaker_cooldown_s,
                )
                self.breakers[index] = breaker
            return breaker

    def add_replica(
        self, index: Optional[int] = None, role: Optional[str] = None
    ) -> int:
        """Build, warm and start one engine. ``index=None`` allocates a
        fresh index (scale-up, which raises :class:`CapacityBlocked` at
        ``capacity``); an explicit index is a relaunch, which keeps the
        index's breaker and is never capacity-checked.

        ``role`` (``"prefill"`` or ``"decode"``) picks a disaggregated pool;
        by default a relaunch keeps its pool and a scale-up joins the decode
        pool (``"both"`` when homogeneous)."""
        from ray_lightning_tpu_torch.serving.engine import (
            EngineConfig,
            InferenceEngine,
        )

        if index is None and self.capacity is not None:
            with self._lock:
                occupied = len(self._replicas) + len(self._draining)
            if occupied >= self.capacity:
                raise CapacityBlocked(
                    f"fleet at capacity ({occupied}/{self.capacity}): no "
                    "free device for a new replica"
                )
        if self._params_cfg is None:
            # one build, shared by every replica: engines never mutate params
            self._params_cfg = self._builder()
        params, cfg = self._params_cfg
        with self._lock:
            if index is None:
                index = self._next_index
                self._next_index += 1
            else:
                self._next_index = max(self._next_index, index + 1)
        if role is None:
            role = self.roles.get(
                index, "decode" if self.disaggregated else "both"
            )
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        ekw = dict(self._engine_kwargs)
        if role != "both":
            ekw["role"] = role
        engine = InferenceEngine(
            params, cfg, EngineConfig(**ekw), device=self.device,
            replica_index=index,
        )
        if self._tenants is not None:
            # the fleet charged the quota at submit
            engine.configure_tenants(self._tenants, admission=False)
        # the kernels' libraries loaded before the replica is routable
        engine.warmup()
        engine.start()
        with self._lock:
            self._replicas[index] = engine
            self.roles[index] = role
            self.routed_total.setdefault(index, 0)
        self._breaker(index)
        self.added_total += 1
        self._publish_size()
        return index

    def num_replicas_of(self, role: str) -> int:
        """Routable replicas in one pool (``"both"`` counts for both)."""
        with self._lock:
            return sum(
                1 for i in self._replicas
                if self.roles.get(i, "both") in (role, "both")
            )

    def remove_replica(
        self, index: Optional[int] = None, role: Optional[str] = None
    ) -> Optional[int]:
        """Drain one replica gracefully (default: the newest). Returns its
        index, or None at the one-replica floor (of the whole fleet, or of
        the ``role`` pool). A drain that times out hands the queued backlog
        back and fails what was admitted, so both retry elsewhere."""
        with self._lock:
            candidates = [
                i for i in self._replicas
                if role is None or self.roles.get(i, "both") in (role, "both")
            ]
            if len(self._replicas) <= 1 or len(candidates) <= 1:
                return None
            if index is None:
                index = max(candidates)
            engine = self._replicas.pop(index)  # leaves routing now
            self._draining[index] = engine

        def drain_and_discard():
            engine.drain(timeout=self.drain_timeout)
            if engine.scheduler.has_work():
                # a wedged replica: the queued backlog is handed back and
                # what it admitted fails over, nothing is silently dropped
                # (the loop, past drain_timeout already, gets the JAX
                # engine's 5 s to leave its step)
                engine.handback_queued()
                engine.shutdown(drain=False, timeout=5.0)
            with self._lock:
                self._draining.pop(index, None)

        t = threading.Thread(
            target=drain_and_discard, daemon=True,
            name=f"rlt-torch-fleet-drain-{index}",
        )
        t.start()
        self._drain_threads.append(t)
        self.removed_total += 1
        self._publish_size()
        return index

    def preempt_replica(self, index: int) -> bool:
        """Preempt one replica: it leaves routing now, its queued backlog is
        handed back (and migrates through the pump), its admitted requests
        finish, then the engine is discarded."""
        with self._lock:
            engine = self._replicas.pop(index, None)
            if engine is None:
                return False
            self._draining[index] = engine
        self._publish_size()
        engine.handback_queued()

        def finish_and_discard():
            engine.drain(timeout=self.drain_timeout)
            with self._lock:
                self._draining.pop(index, None)

        t = threading.Thread(
            target=finish_and_discard, daemon=True,
            name=f"rlt-torch-fleet-preempt-{index}",
        )
        t.start()
        self._drain_threads.append(t)
        return True

    def preempt_all(self) -> None:
        """The whole fleet's preemption notice (the SIGTERM handler's
        target): stop admission and drain everything."""
        self.shutdown()

    # ---------------- the request path ---------------------------------- #
    def submit(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: int = 16,
        eos_id: Any = "__default__",
        on_token: Optional[Callable[[str, int], Any]] = None,
        deadline_ms: Optional[float] = None,
        priority: int = 0,
        request_id: Optional[str] = None,
        max_retries: Optional[int] = None,
        tenant: Optional[str] = None,
    ) -> JournalEntry:
        """Journal the request and route it to the least-loaded replica
        whose breaker admits traffic; returns the journal entry.

        With a tenant registry, ``tenant``'s quota is charged here, once: a
        refusal journals ``quota_rejected`` (never ``shed``) and raises
        :class:`~.tenancy.QuotaExceeded`. A shed or malformed request
        raises the engine's error."""
        deadline = (
            time.perf_counter() + float(deadline_ms) / 1e3
            if deadline_ms is not None
            else None
        )
        entry = self.journal.open(
            tuple(int(t) for t in prompt_tokens),
            max_new_tokens,
            eos_id=eos_id,
            deadline=deadline,
            priority=int(priority),
            on_token=on_token,
            max_retries=(
                self.max_retries if max_retries is None else int(max_retries)
            ),
            request_id=request_id,
            tenant=tenant,
        )
        if (
            self._tenants is not None
            and tenant is not None
            and not self._tenants.admit(tenant)
        ):
            from ray_lightning_tpu_torch.serving.tenancy import QuotaExceeded

            reg = _obs.registry()
            if reg is not None:
                reg.counter(
                    _metrics.TENANT_QUOTA_REJECTED_METRIC,
                    tenant=reg.tenant_label(tenant),
                ).inc()
            err = QuotaExceeded(
                f"tenant {tenant!r} exceeded its admission quota "
                "(token bucket empty); retry after the bucket refills"
            )
            self.journal.finish(
                entry, "quota_rejected", finish_reason="quota", error=err
            )
            raise err
        self._dispatch(entry)
        if entry.done and entry.error is not None:
            raise entry.error
        return entry

    def _dispatch(self, entry: JournalEntry, exclude: Tuple[int, ...] = ()) -> bool:
        """Route one attempt. True when it is live on an engine (or the
        entry reached its disposition); False when no replica can take it
        now: the entry is parked for the pump."""
        if entry.done:
            return True
        if entry.deadline_exceeded():
            self._expire(entry)
            return True
        if entry.remaining_budget() <= 0:
            # the dying replica delivered the whole budget before its
            # failure was seen
            self.journal.finish(entry, "completed", finish_reason="length")
            return True
        with self._lock:
            replicas = dict(self._replicas)
            rr = self._rr
            self._rr += 1
        live = {
            i: eng
            for i, eng in replicas.items()
            if i not in exclude and eng.alive
        }

        def _scan(cands: List[int]) -> Tuple[List[int], Optional[int]]:
            closed: List[int] = []
            probe: Optional[int] = None
            for i in sorted(cands):
                breaker = self._breaker(i)
                if breaker.state == BREAKER_CLOSED:
                    closed.append(i)
                elif probe is None and breaker.allow_request():
                    probe = i  # the half-open probe: this request
            return closed, probe

        affinity_pool = False
        if self.disaggregated:
            # new work prefills on the prefill pool; with no routable
            # prefill replica it falls back to colocated serving on the
            # decode pool
            prefill = [i for i in live if self.roles.get(i) == "prefill"]
            closed, probe = _scan(prefill)
            affinity_pool = True
            if not closed and probe is None:
                affinity_pool = False
                closed, probe = _scan(
                    [i for i in live if self.roles.get(i) != "prefill"]
                )
                if closed or probe is not None:
                    _obs.event(
                        "serve_migration_route_fallback",
                        request_id=entry.request_id,
                    )
        else:
            closed, probe = _scan(list(live))
        if probe is not None:
            index = probe
        elif closed:
            index = None
            if affinity_pool:
                # a prefill replica that recently built this prompt's first
                # block chain serves it from its prefix cache
                warm = self._affinity.get(self._affinity_key(entry.prompt))
                if warm in closed:
                    index = warm
            if index is None:
                loads = {i: live[i].load() for i in closed}
                index = pick_least_loaded(loads, 0, rr, indices=closed)
        else:
            with self._lock:
                self._pending.append(entry)
            return False
        prev_rid = entry.attempt_rid
        rid, prompt, budget = self.journal.begin_attempt(entry, index)
        # the hop's lineage context: hop 0 for the first attempt, parented
        # on the previous attempt's rid for a redispatch. The first dispatch
        # anchors the send stamp at the fleet's submit, so time parked in
        # the fleet lands in the "dispatch" component and the components
        # sum to the TTFT the client saw
        sent_wall = time.time()
        if prev_rid is None:
            sent_wall -= max(0.0, time.perf_counter() - entry.submitted_at)
        trace_ctx = _reqtrace.TraceContext(
            rid=prev_rid or rid,
            base_rid=entry.request_id,
            attempt=entry.attempts,
            hop=max(0, len(entry.replica_history) - 1),
            origin_replica=(
                entry.replica_history[0] if entry.replica_history else index
            ),
            sent_wall=sent_wall,
            tenant=entry.tenant,
        )
        remaining_ms = (
            max((entry.deadline - time.perf_counter()) * 1e3, 0.0)
            if entry.deadline is not None
            else None
        )
        try:
            completion = live[index].submit(
                prompt,
                max_new_tokens=budget,
                request_id=rid,
                eos_id=entry.eos_id,
                on_token=self.journal.stream_guard(entry, rid),
                deadline_ms=remaining_ms,
                priority=entry.priority,
                retries=entry.attempts - 1,
                trace_ctx=trace_ctx,
                tenant=entry.tenant,
            )
        except RequestShed as e:
            self.journal.abort_attempt(entry)
            self.journal.finish(entry, "shed", finish_reason="shed", error=e)
            return True
        except ValueError as e:
            # malformed for every replica (a resumed prompt past
            # max_prompt_len): another replica cannot help
            self.journal.abort_attempt(entry)
            self.journal.finish(
                entry, "failed", finish_reason="error", error=e
            )
            return True
        except Exception as e:  # EngineClosed, RequestQueueFull, a dying replica
            self.journal.abort_attempt(entry)
            nxt = tuple(exclude) + (index,)
            if any(i not in nxt for i in live):
                return self._dispatch(entry, exclude=nxt)
            self.journal.finish(
                entry, "failed", finish_reason="error", error=e
            )
            return True
        self.journal.bind(entry, completion)
        with self._lock:
            self.routed_total[index] = self.routed_total.get(index, 0) + 1
            if self.disaggregated and self.roles.get(index) == "prefill":
                if len(self._affinity) > 4096:
                    self._affinity.clear()  # bounded, best effort
                self._affinity[self._affinity_key(entry.prompt)] = index
        _obs.event(
            "req/route", request_id=rid, replica=index,
            attempt=entry.attempts, track=f"req {entry.request_id}",
        )
        return True

    def _affinity_key(self, prompt: Sequence[int]) -> bytes:
        """The warm-chain affinity key of a prompt: sha256 of its first
        block's tokens as int64 bytes (a shorter prompt hashes what it
        has)."""
        chunk = np.asarray(
            list(prompt[: self._affinity_bs]), dtype=np.int64
        ).tobytes()
        return hashlib.sha256(chunk).digest()

    def _expire(self, entry: JournalEntry) -> None:
        self.journal.finish(entry, "expired", finish_reason="expired")
        reg = _obs.registry()
        if reg is not None:
            reg.counter(_metrics.SERVE_DEADLINE_EXPIRED_METRIC).inc()

    def _retry_or_fail(
        self,
        entry: JournalEntry,
        error: Optional[BaseException],
        exclude: Tuple[int, ...] = (),
    ) -> None:
        if entry.attempts > entry.max_retries:
            self.journal.finish(
                entry,
                "failed",
                finish_reason="error",
                error=error
                or RuntimeError(
                    f"request {entry.request_id!r}: retries exhausted "
                    f"after {entry.attempts} attempts"
                ),
            )
            return
        self._dispatch(
            entry, exclude=tuple(i for i in exclude if i is not None)
        )

    # ---------------- the recovery pump --------------------------------- #
    def _pump_loop(self) -> None:
        while not self._pump_stop.wait(self._pump_interval):
            try:
                self.pump_once()
            except Exception:
                pass  # the pump is the fleet's heart: it must not die

    def pump_once(self) -> None:
        """One sweep: drive the migrations, settle finished attempts
        (feeding the breakers), relaunch dead engines, redispatch parked
        work, publish the breakers' gauges. The pump thread calls it
        continuously; tests call it directly."""
        with self._pump_gate:
            self._pump_locked()

    def _pump_locked(self) -> None:
        # 0) disaggregation: adopt parked exports, drive the migrations
        if self.disaggregated:
            self._pump_migrations()
        # 1) settle finished attempts
        for entry in self.journal.inflight():
            with entry._lock:
                completion = entry.attempt_completion
                replica = entry.replica
            if completion is None or not completion.done:
                continue
            reason = completion.finish_reason
            if completion.error is None and reason in ("eos", "length"):
                if replica is not None:
                    self._breaker(replica).record_success()
                self.journal.finish(entry, "completed", finish_reason=reason)
            elif reason == "expired":
                self._expire(entry)
            elif reason == "cancelled":
                # handed back by a draining or preempted replica: migrate,
                # no failure charged
                self._dispatch(entry)
            else:
                if replica is not None:
                    self._breaker(replica).record_failure()
                self._retry_or_fail(
                    entry, completion.error, exclude=(replica,)
                )
        # 2) discard dead engines and relaunch each under its own index
        #    (its breaker, open or not, survives)
        with self._lock:
            dead = [
                (i, e) for i, e in self._replicas.items() if not e.alive
            ]
            for i, _ in dead:
                self._replicas.pop(i, None)
        for index, engine in dead:
            self.relaunches_total += 1
            _obs.event(
                "serve/replica_dead", replica=index,
                error=repr(engine.failed),
            )
            if self._aggregator is not None:
                self._aggregator.record_event(
                    "serve_replica_dead",
                    replica=index,
                    error=repr(engine.failed),
                )
            if self.relaunch:
                self.add_replica(index=index)
            else:
                self._publish_size()
        # 3) redispatch parked entries
        with self._lock:
            pending, self._pending = self._pending, []
        for entry in pending:
            if not entry.done:
                self._dispatch(entry)
        # 4) the breakers' state gauges
        with self._lock:
            breakers = dict(self.breakers)
        publish_breaker_states(breakers)

    # ---------------- the disaggregated KV migration -------------------- #
    def _pump_migrations(self) -> None:
        """Adopt the freshly parked exports of every prefill replica, then
        run each due migration's send -> verify -> admit ladder."""
        with self._lock:
            replicas = dict(self._replicas)
        for idx, eng in replicas.items():
            if self.roles.get(idx) != "prefill" or not eng.alive:
                continue
            for rid in eng.drain_ready_exports():
                entry = self.journal.get(rid.split("~", 1)[0])
                if entry is None:
                    eng.cancel_export(rid)
                    continue
                with entry._lock:
                    stale = entry.done or entry.attempt_rid != rid
                    comp = entry.attempt_completion
                if stale:
                    # the journal moved on while the export sat parked:
                    # decode in place; the stream guard drops its tokens
                    eng.cancel_export(rid)
                    continue
                self._migrations[rid] = _Migration(entry, idx, rid, comp)
        if not self._migrations:
            return
        now = time.perf_counter()
        finished: List[str] = []
        for rid, mig in list(self._migrations.items()):
            if now >= mig.next_at and self._attempt_migration(mig):
                finished.append(rid)
        for rid in finished:
            self._migrations.pop(rid, None)

    def _pick_decode_target(self, exclude: set) -> Optional[int]:
        """The least-loaded decode replica whose breaker admits traffic (a
        half-open probe as the last resort); None when the decode pool is
        unroutable now."""
        with self._lock:
            replicas = dict(self._replicas)
            rr = self._rr
            self._rr += 1
        cands = [
            i for i, e in replicas.items()
            if i not in exclude and e.alive
            and self.roles.get(i, "both") in ("decode", "both")
        ]
        closed: List[int] = []
        probe: Optional[int] = None
        for i in sorted(cands):
            breaker = self._breaker(i)
            if breaker.state == BREAKER_CLOSED:
                closed.append(i)
            elif probe is None and breaker.allow_request():
                probe = i
        if closed:
            loads = {i: replicas[i].load() for i in closed}
            return pick_least_loaded(loads, 0, rr, indices=closed)
        return probe

    def _attempt_migration(self, mig: _Migration) -> bool:
        """One attempt of one migration. True when the record is finished
        (migrated, fallen back or abandoned); False parks it for a
        backed-off retry.

        No breaker is charged for a corrupt shipment (the receiver proved
        itself healthy by refusing it) or for a capacity refusal; a
        receiver that crashes mid-admit is charged. A failed attempt points
        the journal back at the source attempt (``restore_attempt``); after
        ``max_attempts`` the slot is un-parked and the request decodes on
        the prefill replica."""
        entry = mig.entry
        with self._lock:
            src = self._replicas.get(mig.source)
        with entry._lock:
            stale = entry.done or entry.attempt_rid != mig.source_rid
            if mig.source_completion is None:
                # adopted between the engine's submit and the journal's bind
                mig.source_completion = entry.attempt_completion
        if stale:
            if src is not None and src.alive:
                src.cancel_export(mig.source_rid)
            return True
        if (
            src is None
            or not src.alive
            or (
                mig.source_completion is not None
                and mig.source_completion.done
            )
        ):
            # the source died with the parked slot: the settle and relaunch
            # stages own that recovery
            return True
        policy = self.migration_policy
        reg = _obs.registry()
        mig.attempts += 1
        self.migration_stats.attempts += 1
        if reg is not None:
            reg.counter(_metrics.SERVE_MIGRATION_ATTEMPTS_METRIC).inc()
        failure: Optional[str] = None
        corrupt = False
        began = False
        charge_dst: Optional[int] = None
        dst_idx: Optional[int] = None
        completion = None
        rid2 = None
        t0 = time.perf_counter()
        try:
            if mig.shipment is None:
                mig.shipment = src.export_shipment(mig.source_rid)
            ship = mig.shipment
            # scripted send-side faults, keyed on the source replica and its
            # 1-based shipment count (a stall sleeps in place)
            with self._lock:
                seq = self._ship_seq.get(mig.source, 0) + 1
                self._ship_seq[mig.source] = seq
            spec = _faults.migration_send_fault(mig.source, seq)
            if spec is not None and spec.kind == "drop-shipment":
                raise _migration.ShipmentError(
                    f"scripted fault: shipment #{seq} from replica "
                    f"{mig.source} dropped in flight"
                )
            if spec is not None and spec.kind == "corrupt-shipment":
                ship = _migration.corrupt_copy(ship)
            if time.perf_counter() - t0 > policy.send_timeout_s:
                raise _migration.ShipmentError(
                    f"shipment #{seq} send exceeded "
                    f"{policy.send_timeout_s}s"
                )
            dst_idx = self._pick_decode_target(
                exclude=mig.tried | {mig.source}
            )
            if dst_idx is None:
                raise _migration.MigrationRejected(
                    "no routable decode replica (pool at capacity or "
                    "fully breaker-open)"
                )
            mig.tried.add(dst_idx)
            with self._lock:
                dst = self._replicas.get(dst_idx)
            if dst is None or not dst.alive:
                raise _migration.MigrationRejected(
                    f"decode replica {dst_idx} vanished before admit"
                )
            # the handoff is a migration attempt (~m<K>): no retry charged
            rid2, _prompt, budget = self.journal.begin_attempt(
                entry, dst_idx, migration=True
            )
            began = True
            remaining_ms = (
                max((entry.deadline - time.perf_counter()) * 1e3, 0.0)
                if entry.deadline is not None
                else None
            )
            completion = dst.import_shipment(
                ship,
                max_new_tokens=budget,
                request_id=rid2,
                eos_id=entry.eos_id,
                on_token=self.journal.stream_guard(entry, rid2),
                deadline_ms=remaining_ms,
                priority=entry.priority,
                retries=entry.attempts - 1,
                timeout=policy.admit_timeout_s,
            )
        except _migration.ShipmentCorrupt as e:
            # caught by the receiver's checksums before any device write:
            # keep the receiver eligible for the clean resend
            corrupt = True
            failure = str(e)
            if dst_idx is not None:
                mig.tried.discard(dst_idx)
        except _migration.MigrationRejected as e:
            failure = str(e)  # a capacity verdict: no breaker charge
        except Exception as e:
            failure = repr(e)
            if dst_idx is not None and began:
                # the receiver crashed or timed out mid-admit
                charge_dst = dst_idx
        if failure is None:
            self.journal.bind(entry, completion)
            src.finish_export(mig.source_rid)
            transfer_ms = (time.perf_counter() - t0) * 1e3
            nbytes = mig.shipment.nbytes()
            st = self.migration_stats
            st.verified += 1
            st.migrated += 1
            st.bytes_shipped += nbytes
            st.transfer_ms.append(transfer_ms)
            if reg is not None:
                reg.counter(_metrics.SERVE_MIGRATION_VERIFIED_METRIC).inc()
                reg.counter(_metrics.SERVE_MIGRATION_BYTES_METRIC).inc(nbytes)
                reg.histogram(
                    _metrics.SERVE_MIGRATION_TRANSFER_MS_METRIC,
                    bounds=_TRANSFER_MS_BOUNDS,
                ).observe(transfer_ms, exemplar=rid2)
            with self._lock:
                self.routed_total[dst_idx] = (
                    self.routed_total.get(dst_idx, 0) + 1
                )
            _obs.event(
                "serve_migration", request_id=entry.request_id,
                source=mig.source, dest=dst_idx,
                attempt=mig.attempts, bytes=nbytes,
            )
            return True
        # ---- a failed attempt -------------------------------------------- #
        if began:
            # the source still holds the prefilled slot: from the request's
            # view it never left, and nothing is charged
            self.journal.restore_attempt(
                entry, mig.source, mig.source_rid, mig.source_completion
            )
        if charge_dst is not None:
            self._breaker(charge_dst).record_failure()
        st = self.migration_stats
        if corrupt:
            st.corrupt += 1
            if reg is not None:
                reg.counter(_metrics.SERVE_MIGRATION_CORRUPT_METRIC).inc()
        if mig.attempts >= policy.max_attempts:
            # the budget is spent: un-park, decode on the prefill replica
            st.fallbacks += 1
            if reg is not None:
                reg.counter(_metrics.SERVE_MIGRATION_FALLBACKS_METRIC).inc()
            _obs.event(
                "serve_migration_fallback", request_id=entry.request_id,
                source=mig.source, attempts=mig.attempts, error=failure,
            )
            src.cancel_export(mig.source_rid)
            return True
        st.retries += 1
        if reg is not None:
            reg.counter(_metrics.SERVE_MIGRATION_RETRIES_METRIC).inc()
        mig.next_at = time.perf_counter() + policy.backoff(mig.attempts)
        return False

    # ---------------- views and lifecycle ------------------------------- #
    def attach_aggregator(self, aggregator: Any) -> None:
        """Couple the fleet to an aggregator: replica deaths go to its
        ``record_event``, and the journal's stats become an incident source
        where it has ``register_incident_source``."""
        self._aggregator = aggregator
        if hasattr(aggregator, "register_incident_source"):
            aggregator.register_incident_source("request_journal", self.stats)

    def stats(self) -> Dict[str, Any]:
        """Journal dispositions and the fleet's recovery counters."""
        out: Dict[str, Any] = self.journal.stats()
        out["relaunches"] = self.relaunches_total
        out["routed"] = dict(self.routed_total)
        out["breakers"] = {i: b.state for i, b in self.breakers.items()}
        if self.disaggregated:
            out["roles"] = dict(self.roles)
            out["migration"] = self.migration_stats.as_dict()
        return out

    def drain_request_records(self) -> List[Dict[str, Any]]:
        """Every live engine's finished-request trace records (none with
        telemetry off). A disaggregated request's hops finish on different
        replicas, so a lineage-complete ``requests.jsonl`` needs them all."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            engines = list(self._replicas.values())
        for engine in engines:
            try:
                out.extend(engine.drain_request_records())
            except Exception:
                continue
        return out

    def shutdown(self) -> None:
        """Un-park every export still waiting on a migration (a parked slot
        never finishes on its own), drain every replica, stop the pump,
        settle the last completions; what is still in flight ends
        ``"failed"``."""
        if self.disaggregated:
            with self._pump_gate:
                for rid, mig in list(self._migrations.items()):
                    with self._lock:
                        src = self._replicas.get(mig.source)
                    if src is not None and src.alive:
                        src.cancel_export(rid)
                self._migrations.clear()
        with self._lock:
            engines = list(self._replicas.values())
            self._replicas.clear()
        for engine in engines:
            engine.drain(timeout=self.drain_timeout)
        del engines
        for t in self._drain_threads:
            t.join(timeout=30)
        self._pump_stop.set()
        if self._pump_thread.is_alive():
            self._pump_thread.join(timeout=5)
        self.pump_once()  # settle the final completions
        for entry in self.journal.inflight():
            self.journal.finish(
                entry,
                "failed",
                finish_reason="error",
                error=RuntimeError("fleet shut down"),
            )

    def _publish_size(self) -> None:
        reg = _obs.registry()
        if reg is not None:
            reg.gauge("rlt_serve_replicas").set(self.num_replicas)


# --------------------------------------------------------------------- #
# the replica actor
# --------------------------------------------------------------------- #
class ServeReplicaActor:
    """One engine in one actor process, built inside the actor from
    ``builder()`` (``(params, cfg)`` on ``device``, the card unless
    ``device="cpu"``), so the weights never cross from the main process. The
    kernels' libraries are loaded before the ready handshake. With a
    ``heartbeat`` queue handle, a thread puts ``(replica_index,
    decode_steps, wall_time, payload)`` every ``heartbeat_interval``
    seconds, ``payload`` being ``{"load": engine.load()}``; with
    ``telemetry`` (enabled in the actor's process before the engine is
    built) also the metric deltas and trace events (``"m"``, ``"t"``) and
    the finished requests' records (``"r"``)."""

    def __init__(
        self,
        builder: Callable[[], Tuple[Any, Any]],
        engine_kwargs: Optional[Dict[str, Any]] = None,
        replica_index: int = 0,
        heartbeat: Optional[Any] = None,
        heartbeat_interval: float = 0.5,
        telemetry: bool = False,
        device: DeviceLike = None,
    ):
        from ray_lightning_tpu_torch.serving.engine import (
            EngineConfig,
            InferenceEngine,
        )

        if telemetry:
            _obs.enable()
        params, cfg = builder()
        self.replica_index = int(replica_index)
        # replica_index arms this replica's TORCHRT_FAULT serving specs
        self.engine = InferenceEngine(
            params, cfg, EngineConfig(**(engine_kwargs or {})),
            device=device, replica_index=self.replica_index,
        )
        self._finished: Dict[str, Dict[str, Any]] = {}
        self._install_finish_hook()
        self.engine.warmup()
        self.engine.start()
        self._hb = heartbeat
        self._hb_interval = max(float(heartbeat_interval), 0.05)
        self._hb_stop = threading.Event()
        if heartbeat is not None:
            threading.Thread(
                target=self._beat_loop, daemon=True,
                name="rlt-torch-serve-hb",
            ).start()

    def _beat_loop(self) -> None:
        while not self._hb_stop.wait(self._hb_interval):
            _obs.sample_device_memory()  # the memory gauges ride the beat
            payload: Dict[str, Any] = {"load": self.engine.load()}
            telemetry = _obs.collect_beat_payload()
            if telemetry is not None:
                payload.update(telemetry)
            records = self.engine.drain_request_records()
            if records:
                payload["r"] = records
            try:
                self._hb.put(
                    (
                        self.replica_index,
                        int(self.engine.stats["decode_steps"]),
                        time.time(),
                        payload,
                    ),
                    timeout=1.0,
                )
            except Exception:
                pass  # a wedged heartbeat queue must not kill serving

    # ---------------- the actor surface (one executor thread) --------- #
    def submit(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: int = 16,
        eos_id: Any = "__default__",
        request_id: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        priority: int = 0,
        retries: int = 0,
    ) -> str:
        completion = self.engine.submit(
            prompt_tokens,
            max_new_tokens=max_new_tokens,
            request_id=request_id,
            eos_id=eos_id,
            deadline_ms=deadline_ms,
            priority=int(priority),
            retries=int(retries),
        )
        return completion.request_id

    def handback(self) -> List[Dict[str, Any]]:
        """Stop admission and return the queued (never admitted) backlog as
        resubmittable specs."""
        return self.engine.handback_queued()

    def poll(self, request_id: str) -> Dict[str, Any]:
        completion = self.engine._completions.get(request_id)
        if completion is None:
            done = self._finished.get(request_id)
            if done is None:
                raise KeyError(f"unknown request {request_id!r}")
            return done
        return {"done": False, "tokens": list(completion.tokens)}

    def load(self) -> Dict[str, Any]:
        return self.engine.load()

    def describe(self) -> Dict[str, Any]:
        return self.engine.describe()

    def ping(self) -> bool:
        return True

    def kernel_launches(self) -> Dict[str, int]:
        """The CUDA kernels' launch counts in this actor's process (the
        main process's own counts never see an actor's launches)."""
        return self.engine.kernel_launches()

    def drain(self) -> None:
        self._hb_stop.set()
        self.engine.drain()

    def _install_finish_hook(self) -> None:
        # park finished results (at most 4096) so that poll() serves them
        # after the engine forgets the completion
        cache = self._finished
        engine_finish = self.engine._finish
        completions = self.engine._completions

        def finish_and_park(request_id, reason, error=None):
            completion = completions.get(request_id)
            if completion is not None:
                cache[request_id] = {
                    "done": True,
                    "tokens": list(completion.tokens),
                    "finish_reason": reason,
                    "error": repr(error) if error else None,
                }
                if len(cache) > 4096:
                    cache.pop(next(iter(cache)))
            engine_finish(request_id, reason, error)

        self.engine._finish = finish_and_park


# --------------------------------------------------------------------- #
# the caller's future and group
# --------------------------------------------------------------------- #
class ServeFuture:
    """The caller's handle of a routed request: polls the owning replica."""

    def __init__(self, group: "ReplicaGroup", replica: int, request_id: str):
        self.replica = replica
        self.request_id = request_id
        self._group = group

    def result(
        self, timeout: Optional[float] = 120.0, poll_interval: float = 0.05
    ) -> List[int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            state = self._group._poll(self.replica, self.request_id)
            if state.get("done"):
                if state.get("error"):
                    raise RuntimeError(
                        f"request {self.request_id!r} failed on replica "
                        f"{self.replica}: {state['error']}"
                    )
                return list(state["tokens"])
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"request {self.request_id!r} not finished within "
                    f"{timeout}s (replica {self.replica})"
                )
            time.sleep(poll_interval)


class ReplicaGroup:
    """N :class:`ServeReplicaActor` processes behind one front door.

    ``builder`` is pickled by reference (a module-level function or a
    ``functools.partial`` of one: a lambda or a closure raises
    ``TypeError`` at :meth:`start`). ``device`` is each actor's engine
    device (the card unless ``"cpu"``); ``env`` is applied to the actors'
    environment. ``hang_timeout`` arms the per-replica relaunch policy
    (None: monitor only); the Supervisor always runs in monitor mode.

    Elastic: :meth:`add_replica` launches an actor under a fresh index (an
    index is never reused while a future may poll it) and
    :meth:`remove_replica` drains one: it leaves routing at once, finishes
    what it admitted, and is released only after every outstanding
    :class:`ServeFuture` of it was collected. Requests carry group-minted
    ids (``g<N>``, ``~r<k>`` for a retry) and are resubmitted as ``prompt +
    tokens so far`` when their replica dies, hangs or times out its drain,
    up to ``max_retries``. ``telemetry=True`` turns telemetry on in every
    actor (their beats carry metric deltas, trace events and request
    records, which the group's :class:`_LoadTap` drops, keeping the load,
    as the JAX package's does) and, where it is on in this process, the
    ``rlt_serve_replicas`` gauge, the retries counter and ``req/route``
    events."""

    def __init__(
        self,
        builder: Callable[[], Tuple[Any, Any]],
        engine_kwargs: Optional[Dict[str, Any]] = None,
        num_replicas: int = 2,
        hang_timeout: Optional[float] = None,
        startup_timeout: Optional[float] = None,
        heartbeat_interval: float = 0.5,
        env: Optional[Dict[str, str]] = None,
        telemetry: bool = False,
        actor_timeout: float = 180.0,
        max_retries: int = 2,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 10.0,
        device: DeviceLike = None,
    ):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        self._builder = builder
        self._engine_kwargs = dict(engine_kwargs or {})
        self._initial_replicas = int(num_replicas)
        self.hang_timeout = hang_timeout
        self.startup_timeout = startup_timeout
        self.heartbeat_interval = float(heartbeat_interval)
        self._env = env
        self._telemetry = bool(telemetry)
        self._device = None if device is None else str(device)
        self._actor_timeout = float(actor_timeout)
        self.handles: Dict[int, Any] = {}
        self.tap = _LoadTap()
        self.relaunches_total = 0
        self.added_total = 0
        self.removed_total = 0
        self._next_index = 0
        self._draining: set = set()
        self._inflight: Dict[str, int] = {}  # request id -> replica index
        self._drain_threads: List[threading.Thread] = []
        self._rr = 0
        self._lock = threading.Lock()
        self._queue = None
        self._supervisor = None
        # request recovery: the group's ids and resubmission records, and
        # a circuit breaker a replica index
        self.max_retries = int(max_retries)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.breakers: Dict[int, CircuitBreaker] = {}
        self.routed_total: Dict[int, int] = {}
        self.retries_total = 0
        self._meta: Dict[str, Dict[str, Any]] = {}
        self._req_seq = itertools.count()

    def _breaker(self, index: int) -> CircuitBreaker:
        with self._lock:
            breaker = self.breakers.get(index)
            if breaker is None:
                breaker = CircuitBreaker(
                    failure_threshold=self.breaker_threshold,
                    open_cooldown_s=self.breaker_cooldown_s,
                )
                self.breakers[index] = breaker
            return breaker

    @property
    def num_replicas(self) -> int:
        """Routable replicas (draining ones no longer count)."""
        if not self.handles and self._next_index == 0:
            return self._initial_replicas  # before start
        return len(self.handles) - len(self._draining)

    # ------------------------------ lifecycle -------------------------- #
    def start(self) -> "ReplicaGroup":
        from ray_lightning_tpu_torch.runtime import api as rt
        from ray_lightning_tpu_torch.runtime.queue import make_queue
        from ray_lightning_tpu_torch.runtime.supervisor import Supervisor

        if self.handles:
            return self
        if not rt.is_initialized():
            rt.init()
        self._queue = make_queue()
        indices = list(range(self._initial_replicas))
        try:
            created = rt.create_actors(
                [self._spec(i) for i in indices],
                names=[self._name(i) for i in indices],
                env=self._env,
                timeout=self._actor_timeout,
            )
        except BaseException:
            self._queue.shutdown()
            self._queue = None
            raise
        self.handles = dict(zip(indices, created))
        self._next_index = self._initial_replicas
        # monitor mode: beats and ages into the tap; the relaunch policy is
        # check()'s, per replica. A replica added later registers at its
        # first beat.
        self._supervisor = Supervisor(
            num_workers=self._initial_replicas,
            drain=self._queue.get_all,
            hang_timeout=None,
            heartbeat_interval=self.heartbeat_interval,
            label="serve-replicas",
            aggregator=self.tap,
        )
        self._supervisor.start()
        return self

    # ------------------------------ elasticity ------------------------- #
    def add_replica(self) -> int:
        """Launch one more replica actor; returns its (new) index."""
        from ray_lightning_tpu_torch.runtime import api as rt

        if not self.handles:
            raise RuntimeError("ReplicaGroup.start() first")
        with self._lock:
            index = self._next_index
            self._next_index += 1
        handle = rt.create_actors(
            [self._spec(index)],
            names=[self._name(index)],
            env=self._env,
            timeout=self._actor_timeout,
        )[0]
        with self._lock:
            self.handles[index] = handle
        self.added_total += 1
        self.tap.record_event("serve_replica_added", replica=index)
        self._publish_size()
        return index

    def remove_replica(self, index: Optional[int] = None) -> Optional[int]:
        """Drain one replica (default: the newest routable). Returns its
        index, or None at the one-replica floor. It leaves routing before
        the drain starts, finishes what it admitted, and is released once
        every outstanding future of it was collected."""
        with self._lock:
            routable = [i for i in self.handles if i not in self._draining]
            if len(routable) <= 1:
                return None
            if index is None:
                index = max(routable)
            elif index not in routable:
                raise ValueError(f"replica {index} is not routable")
            self._draining.add(index)
            handle = self.handles[index]
            self.tap.loads.pop(index, None)
        self.tap.record_event("serve_replica_drain", replica=index)

        def drain_and_release():
            from ray_lightning_tpu_torch.runtime import api as rt

            try:
                handle.drain.remote().result(timeout=self._actor_timeout)
            except Exception:
                # the drain timed out or the actor died: pull the queued
                # backlog back and mark it for redispatch
                try:
                    specs = handle.handback.remote().result(timeout=10.0)
                except Exception:
                    specs = []
                self._recover_handback(index, specs)
            # futures poll by index: hold the actor until each was served
            deadline = time.monotonic() + self._actor_timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if index not in self._inflight.values():
                        break
                time.sleep(0.05)
            try:
                rt.kill(handle)
            except Exception:
                pass
            with self._lock:
                self.handles.pop(index, None)
                self._draining.discard(index)
            if self._supervisor is not None:
                self._supervisor.health.pop(index, None)

        t = threading.Thread(
            target=drain_and_release, daemon=True,
            name=f"rlt-torch-serve-drain-{index}",
        )
        t.start()
        self._drain_threads.append(t)
        self.removed_total += 1
        self._publish_size()
        return index

    def _publish_size(self) -> None:
        reg = _obs.registry()
        if reg is not None:
            reg.gauge("rlt_serve_replicas").set(self.num_replicas)

    def _spec(self, index: int):
        return (
            ServeReplicaActor,
            (
                self._builder,
                self._engine_kwargs,
                index,
                self._queue.handle(),
                self.heartbeat_interval,
                self._telemetry,
                self._device,
            ),
            None,
        )

    def _name(self, index: int) -> str:
        return f"serve-replica-{index}-gen{self.relaunches_total}"

    def shutdown(self) -> None:
        from ray_lightning_tpu_torch.runtime import api as rt

        if self._supervisor is not None:
            self._supervisor.stop()
            self._supervisor = None
        for t in self._drain_threads:
            t.join(timeout=30)
        for handle in list(self.handles.values()):
            try:
                handle.drain.remote().result(timeout=30)
            except Exception:
                pass
            try:
                rt.kill(handle)
            except Exception:
                pass
        self.handles = {}
        self._draining = set()
        if self._queue is not None:
            try:
                self._queue.shutdown()
            except Exception:
                pass
            self._queue = None

    def preempt_all(self) -> None:
        """The preemption notice (the SIGTERM handler's target): drain every
        replica, then release them."""
        self.shutdown()

    # ------------------------------ routing ---------------------------- #
    def submit(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: int = 16,
        eos_id: Any = "__default__",
        deadline_ms: Optional[float] = None,
        priority: int = 0,
    ) -> ServeFuture:
        """Route one request under a group-minted id; returns its
        :class:`ServeFuture`."""
        if not self.handles:
            raise RuntimeError("ReplicaGroup.start() first")
        rid = f"g{next(self._req_seq)}"
        meta: Dict[str, Any] = {
            "prompt": [int(t) for t in prompt_tokens],
            "max_new_tokens": int(max_new_tokens),
            "eos_id": eos_id,
            "deadline": (
                time.monotonic() + float(deadline_ms) / 1e3
                if deadline_ms is not None
                else None
            ),
            "priority": int(priority),
            "prefix": [],     # tokens recovered from ended attempts
            "last_seen": [],  # the current attempt's tokens at the last poll
            "attempts": 0,
            "exclude": (),
        }
        with self._lock:
            self._meta[rid] = meta
        replica = self._dispatch_rid(rid, meta)
        return ServeFuture(self, replica, rid)

    def _dispatch_rid(
        self, rid: str, meta: Dict[str, Any], exclude: Sequence[int] = ()
    ) -> int:
        """(Re)submit one journaled request to a breaker-approved replica;
        raises when nothing is routable now (the next poll retries)."""
        with self._lock:
            routable = [
                i for i in self.handles
                if i not in self._draining and i not in exclude
            ]
            rr = self._rr
            self._rr += 1
        closed: List[int] = []
        probe: Optional[int] = None
        for i in sorted(routable):
            breaker = self._breaker(i)
            if breaker.state == BREAKER_CLOSED:
                closed.append(i)
            elif probe is None and breaker.allow_request():
                probe = i
        if probe is not None:
            replica = probe
        elif closed:
            replica = pick_least_loaded(
                self.tap.snapshot(), 0, rr, indices=closed
            )
        elif routable:
            # every breaker refuses and no probe is due: the group has no
            # parking pump, so availability wins
            replica = pick_least_loaded(
                self.tap.snapshot(), 0, rr, indices=routable
            )
        else:
            raise RuntimeError("no routable replicas")
        meta["attempts"] += 1
        attempt = meta["attempts"]
        attempt_rid = rid if attempt == 1 else f"{rid}~r{attempt - 1}"
        prompt = meta["prompt"] + meta["prefix"]
        budget = meta["max_new_tokens"] - len(meta["prefix"])
        remaining_ms = None
        if meta["deadline"] is not None:
            remaining_ms = max(
                (meta["deadline"] - time.monotonic()) * 1e3, 0.0
            )
        with self._lock:
            # count the routed request here, so that a burst between two
            # beats does not all land on one replica
            entry = self.tap.loads.setdefault(replica, {})
            entry["queue_depth"] = float(entry.get("queue_depth", 0)) + 1
            handle = self.handles[replica]
        handle.submit.remote(
            list(prompt), budget, meta["eos_id"], attempt_rid,
            remaining_ms, meta["priority"], attempt - 1,
        ).result(timeout=30)
        with self._lock:
            self._inflight[rid] = replica
            meta["attempt_rid"] = attempt_rid
            meta["last_seen"] = []
            self.routed_total[replica] = (
                self.routed_total.get(replica, 0) + 1
            )
        if attempt > 1:
            self.retries_total += 1
            reg = _obs.registry()
            if reg is not None:
                reg.counter(_metrics.SERVE_RETRIES_METRIC).inc()
        # the routing leg of the request's trace: an instant on the
        # request's own track in this process (the engine's spans are in
        # the replica's)
        _obs.event(
            "req/route", request_id=rid, replica=replica,
            attempt=attempt, track=f"req {rid}",
        )
        return replica

    def _poll(self, replica: int, request_id: str) -> Dict[str, Any]:
        with self._lock:
            replica = self._inflight.get(request_id, replica)
            handle = self.handles.get(replica)
            meta = self._meta.get(request_id)
        if meta is None:
            # a request submitted to the actor directly: no recovery
            if handle is None:
                raise RuntimeError(
                    f"replica {replica} is gone with request "
                    f"{request_id!r} unresolved (released before "
                    "collection)"
                )
            state = handle.poll.remote(request_id).result(timeout=30)
            if state.get("done"):
                with self._lock:
                    self._inflight.pop(request_id, None)
            return state
        terminal = meta.get("terminal")
        if terminal is not None:
            return terminal
        if meta.get("needs_dispatch"):
            # a relaunch or hand-back ended the last attempt before a poll
            # saw it: redispatch from the record
            try:
                self._dispatch_rid(
                    request_id, meta, exclude=meta.get("exclude", ())
                )
                meta["needs_dispatch"] = False
                with self._lock:
                    replica = self._inflight.get(request_id, replica)
                    handle = self.handles.get(replica)
            except Exception:
                return {"done": False, "tokens": list(meta["prefix"])}
        attempt_rid = meta.get("attempt_rid", request_id)
        state: Optional[Dict[str, Any]] = None
        failure: Optional[str] = None
        if handle is None:
            failure = f"replica {replica} is gone"
        else:
            try:
                state = handle.poll.remote(attempt_rid).result(timeout=30)
            except Exception as e:
                failure = repr(e)
        if state is not None and state.get("done"):
            if state.get("finish_reason") == "cancelled":
                # handed back by a draining replica: migrate, no charge
                return self._reroute(
                    request_id, meta, replica,
                    charge=False, last_error="cancelled",
                )
            if state.get("error"):
                failure = str(state["error"])
        if failure is not None:
            return self._reroute(
                request_id, meta, replica, charge=True, last_error=failure
            )
        tokens = meta["prefix"] + list(state.get("tokens", ()))
        if state.get("done"):
            self._breaker(replica).record_success()
            out = dict(state)
            out["tokens"] = tokens
            out["retries"] = meta["attempts"] - 1
            with self._lock:
                self._inflight.pop(request_id, None)
                meta["prefix"] = list(tokens)
                meta["terminal"] = out
            return out
        with self._lock:
            meta["last_seen"] = list(state.get("tokens", ()))
        return {"done": False, "tokens": tokens}

    def _reroute(
        self,
        rid: str,
        meta: Dict[str, Any],
        failed_replica: int,
        charge: bool,
        last_error: str,
    ) -> Dict[str, Any]:
        """An attempt died (or was handed back): roll its delivered tokens
        into the prefix and redispatch elsewhere."""
        if charge:
            self._breaker(failed_replica).record_failure()
        with self._lock:
            meta["prefix"] = meta["prefix"] + list(meta.get("last_seen", []))
            meta["last_seen"] = []
            self._inflight.pop(rid, None)
        if charge and meta["attempts"] > self.max_retries:
            out = {
                "done": True,
                "tokens": list(meta["prefix"]),
                "finish_reason": "error",
                "error": (
                    f"retries exhausted after {meta['attempts']} attempts"
                    f" (last: {last_error})"
                ),
            }
            with self._lock:
                meta["terminal"] = out
            return out
        self.tap.record_event(
            "serve_request_reroute", request_id=rid,
            from_replica=failed_replica, reason=last_error,
        )
        if len(meta["prefix"]) >= meta["max_new_tokens"]:
            # the dead replica had produced the whole budget
            out = {
                "done": True,
                "tokens": list(meta["prefix"]),
                "finish_reason": "length",
                "retries": meta["attempts"] - 1,
            }
            with self._lock:
                meta["terminal"] = out
            return out
        try:
            self._dispatch_rid(rid, meta, exclude=(failed_replica,))
        except Exception:
            meta["needs_dispatch"] = True
            meta["exclude"] = (failed_replica,)
        return {"done": False, "tokens": list(meta["prefix"])}

    def loads(self) -> Dict[int, Dict[str, float]]:
        return self.tap.snapshot()

    # ------------------------------ health ----------------------------- #
    def check(self) -> Dict[int, str]:
        """Classify the replicas from the supervisor's beats and relaunch
        the condemned (dead, or silent past ``hang_timeout``). Returns
        ``{index: "ok" | "relaunched"}``."""
        out: Dict[int, str] = {}
        if self._supervisor is None:
            return out
        now = time.monotonic()
        with self._lock:
            indices = [i for i in self.handles if i not in self._draining]
        for index in indices:
            health = self._supervisor.health.get(index)
            dead = not self._is_alive(index)
            condemned = dead or needs_relaunch(
                health.last_beat if health else None,
                health.started if health else now,
                now,
                self.hang_timeout,
                self.startup_timeout,
            )
            if condemned:
                self._relaunch(index, reason="dead" if dead else "hung")
                out[index] = "relaunched"
            else:
                out[index] = "ok"
        return out

    def _is_alive(self, index: int) -> bool:
        try:
            return bool(
                self.handles[index].ping.remote().result(timeout=5.0)
            )
        except Exception:
            return False

    def _relaunch(self, index: int, reason: str) -> None:
        from ray_lightning_tpu_torch.runtime import api as rt
        from ray_lightning_tpu_torch.runtime.supervisor import WorkerHealth

        self.tap.record_event(
            "serve_replica_relaunch", replica=index, reason=reason
        )
        try:
            rt.kill(self.handles[index], force=True)
        except Exception:
            pass
        self.relaunches_total += 1
        self.handles[index] = rt.create_actors(
            [self._spec(index)],
            names=[self._name(index)],
            env=self._env,
            timeout=self._actor_timeout,
        )[0]
        # a fresh start-up grace window for the fresh replica
        self._supervisor.health[index] = WorkerHealth(rank=index)
        with self.tap._lock:
            self.tap.loads.pop(index, None)
        # the old actor died with requests on it: one breaker charge, and
        # every request in flight there is marked for redispatch (the
        # relaunched actor stays a candidate)
        self._breaker(index).record_failure()
        with self._lock:
            victims = [
                rid for rid, idx in self._inflight.items() if idx == index
            ]
            for rid in victims:
                meta = self._meta.get(rid)
                if meta is not None:
                    meta["prefix"] = (
                        meta["prefix"] + list(meta.get("last_seen", []))
                    )
                    meta["last_seen"] = []
                    meta["needs_dispatch"] = True
                    meta["exclude"] = ()
                    self._inflight.pop(rid, None)

    def _recover_handback(
        self, failed_index: int, specs: Sequence[Dict[str, Any]]
    ) -> None:
        """Mark handed-back queued requests for redispatch elsewhere."""
        for spec in specs:
            base = str(spec.get("request_id", "")).split("~", 1)[0]
            with self._lock:
                meta = self._meta.get(base)
                if meta is not None and meta.get("terminal") is None:
                    meta["needs_dispatch"] = True
                    meta["exclude"] = (failed_index,)
                    self._inflight.pop(base, None)
            self.tap.record_event(
                "serve_request_handback",
                request_id=base, replica=failed_index,
            )
