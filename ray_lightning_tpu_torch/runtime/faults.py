"""Deterministic fault injection for training (``ray_lightning_tpu/runtime/
faults.py``, its rank family): script exact failure sequences for the
relaunch and hang-supervision tests without flaky sleeps.

The spec reaches every worker process through the environment, under the
port's own prefix; this module is the only one of the port that reads these
variables:

``TORCHRT_FAULT`` — comma-separated fault specs::

    rank<R>:<kind>@<where>[:<arg>]

    rank1:crash@step5          # os._exit(1) at the START of global step 5
    rank0:hang@step3           # block forever at step 3 (supervisor food)
    rank2:slow@step4:2.5       # sleep 2.5s at step 4 (straggler)
    rank1:drop-heartbeats@step2  # stay alive but go silent from step 2 on
    rank0:crash@boot           # die during actor bring-up, before the
                               # ready handshake (startup-failure path)
    rank1:crash@every:5        # die at every global step that is a
                               # positive multiple of 5

Step faults fire at the start of the named global training step (the
Trainer's health tick, ``core/trainer.py``); boot faults fire in
``runtime/actor_boot.py`` before the actor announces readiness, so the
spawner sees a start-up failure. ``drop-heartbeats`` is distinct from
``hang``: the worker keeps training but its liveness channel goes dark.

``TORCHRT_FAULT_FUSE`` — a directory. When set, each spec fires at most once
across process relaunches (a marker file per spec is written, and synced,
before firing): the relaunched worker replays the same steps, matches the
same spec and skips it. Without a fuse directory a fault is a pure function
of (rank, step). ``@every:N`` specs burn one marker per firing step.

``TORCHRT_GLOBAL_RANK`` is the rank, set by the launcher for each worker.
Step faults default to rank 0 when it is unset, so that a Trainer in the
main process can be tested too; boot faults require it, so that a queue
actor or a trial runner never matches a rank-0 spec.

Serving fault points share the variable under a ``replica`` prefix
(``serving/engine.py`` hooks them per scheduler tick and per admitted
request of an engine built with ``replica_index=R``)::

    replica<R>:<kind>@<where>[:<arg>]

    replica0:crash@tick8           # the engine loop dies at tick 8
    replica0:crash@every:8         # at every 8th tick
    replica1:hang@tick5            # the loop blocks forever at tick 5
    replica0:slow-decode@every:4:0.05  # a 50 ms stall every 4th tick
    replica1:crash@req3            # die while admitting the 3rd request
    replica0:drop-stream@req2:4    # the 2nd admitted request loses its
                                   # stream after 4 generated tokens

A serving ``crash`` raises :class:`ServeFault` in the engine loop instead
of ``os._exit``: engines are threads of one process, and the death under
test is one engine's. The migration kinds share the ``replica`` prefix and
are told apart by their names::

    replica<R>:<kind>@<req<N>|every:<N>>[:<arg>]

    replica0:drop-shipment@req1        # the 1st shipment leaving replica
                                       # 0 vanishes
    replica0:corrupt-shipment@every:2  # every 2nd one has a bit flipped
    replica0:stall-shipment@req2:0.5   # the 2nd stalls 0.5 s at the send
    replica1:crash-mid-admit@req1      # decode replica 1 dies admitting
                                       # its 1st shipment, after verify

Send-point kinds key on the source replica and its 1-based shipment
count (``migration_send_fault``, the caller's pump simulates the loss or
the flip); ``crash-mid-admit`` keys on the destination and its 1-based
import count. The rank, serving and migration parsers each skip the
others' specs; ``arbiter`` specs (the JAX package's chip arbiter) are
skipped by all of them, as no module of the port reads them yet.
"""
from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

FAULT_ENV = "TORCHRT_FAULT"
FUSE_ENV = "TORCHRT_FAULT_FUSE"
RANK_ENV = "TORCHRT_GLOBAL_RANK"

BOOT = "boot"

_SPEC_RE = re.compile(
    r"^rank(?P<rank>\d+):(?P<kind>crash|hang|slow|drop-heartbeats)"
    r"(?:@(?:step(?P<step>\d+)|every:(?P<every>\d+)|(?P<boot>boot)))?"
    r"(?::(?P<arg>[0-9.]+))?$"
)

# every known spec family, by prefix: a spec of another family is skipped,
# one of no family is an error
_FAMILIES = ("rank", "replica", "arbiter")


def _spec_family(raw: str) -> Optional[str]:
    """The family prefix a raw spec belongs to, or None."""
    for fam in _FAMILIES:
        if raw.startswith(fam):
            return fam
    return None


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: ``kind`` fires for ``rank`` at ``at`` (a global
    step, or ``"boot"``), or at every positive multiple of ``every``.
    ``seconds`` is a slow fault's stall."""

    rank: int
    kind: str
    at: Union[int, str] = 0
    seconds: float = 0.0
    every: Optional[int] = None

    @property
    def fuse_id(self) -> str:
        if self.every is not None:
            return f"rank{self.rank}-{self.kind}-every{self.every}"
        return f"rank{self.rank}-{self.kind}-at{self.at}"

    def fuse_id_at(self, step: int) -> str:
        """The marker of one firing: a repeating spec burns one a step."""
        if self.every is not None:
            return f"{self.fuse_id}-s{step}"
        return self.fuse_id

    def matches_step(self, step: int) -> bool:
        if self.every is not None:
            return step > 0 and step % self.every == 0
        return self.at == step


def parse_faults(text: Optional[str]) -> List[FaultSpec]:
    """Parse a ``TORCHRT_FAULT`` value; raises ValueError naming the bad
    spec. ``drop-heartbeats`` defaults to ``@step0``; every other kind needs
    ``@step<N>``, ``@every:<N>`` or ``@boot``."""
    if not text:
        return []
    specs: List[FaultSpec] = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        if _spec_family(raw) not in (None, "rank"):
            continue
        m = _SPEC_RE.match(raw)
        if m is None:
            raise ValueError(
                f"bad {FAULT_ENV} spec {raw!r}: expected "
                "rank<R>:<crash|hang|slow|drop-heartbeats>"
                "@<step<N>|every:<N>|boot>[:<seconds>]")
        kind = m.group("kind")
        every: Optional[int] = None
        at: Union[int, str] = 0
        if m.group("every") is not None:
            every = int(m.group("every"))
            if every < 1:
                raise ValueError(
                    f"bad {FAULT_ENV} spec {raw!r}: @every needs N >= 1")
            if kind == "drop-heartbeats":
                raise ValueError(
                    f"bad {FAULT_ENV} spec {raw!r}: drop-heartbeats is "
                    "already persistent (silent from @step<N> on); @every "
                    "does not apply")
        elif m.group("boot"):
            at = BOOT
        elif m.group("step") is not None:
            at = int(m.group("step"))
        elif kind != "drop-heartbeats":
            raise ValueError(
                f"bad {FAULT_ENV} spec {raw!r}: {kind} needs an explicit "
                "@step<N>, @every:<N> or @boot")
        if kind == "slow" and m.group("arg") is None:
            raise ValueError(
                f"bad {FAULT_ENV} spec {raw!r}: slow needs a stall length, "
                "e.g. rank0:slow@step3:2.5")
        if at == BOOT and kind in ("slow", "drop-heartbeats"):
            raise ValueError(
                f"bad {FAULT_ENV} spec {raw!r}: only crash/hang make sense "
                "at boot")
        specs.append(FaultSpec(rank=int(m.group("rank")), kind=kind, at=at,
                               seconds=float(m.group("arg") or 0.0),
                               every=every))
    return specs


# the parse of the last value seen: the health tick runs once a step and
# must not parse again
_cache: Tuple[Optional[str], List[FaultSpec]] = (None, [])


def _env_specs() -> List[FaultSpec]:
    global _cache
    text = os.environ.get(FAULT_ENV)
    if text != _cache[0]:
        _cache = (text, parse_faults(text))
    return _cache[1]


def _rank(default: Optional[int] = 0) -> Optional[int]:
    raw = os.environ.get(RANK_ENV)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _marker(spec: FaultSpec, step: Optional[int]) -> Optional[str]:
    fuse_dir = os.environ.get(FUSE_ENV)
    if not fuse_dir:
        return None
    return os.path.join(fuse_dir, spec.fuse_id if step is None
                        else spec.fuse_id_at(step))


def _fuse_blown(spec: FaultSpec, step: Optional[int] = None) -> bool:
    marker = _marker(spec, step)
    return marker is not None and os.path.exists(marker)


def _blow_fuse(spec: FaultSpec, step: Optional[int] = None) -> None:
    marker = _marker(spec, step)
    if marker is None:
        return
    os.makedirs(os.path.dirname(marker), exist_ok=True)
    # on disk before the fault fires: a crash must not lose its marker
    with open(marker, "w") as f:
        f.write(str(time.time()))
        f.flush()
        os.fsync(f.fileno())


def _fire(spec: FaultSpec, step: Optional[int] = None) -> None:
    _blow_fuse(spec, step)
    if spec.kind == "crash":
        os._exit(1)
    elif spec.kind == "hang":
        # a real hang: nothing in this thread runs again; only an external
        # kill (the supervisor's) ends it
        while True:
            time.sleep(60)
    elif spec.kind == "slow":
        time.sleep(spec.seconds)


def fire_step_faults(step: int) -> None:
    """The Trainer's hook: fire a crash, hang or slow fault scripted for
    this rank at this global step. A no-op without ``TORCHRT_FAULT``."""
    specs = _env_specs()
    if not specs:
        return
    rank = _rank(default=0)
    for spec in specs:
        if (spec.rank == rank and spec.kind in ("crash", "hang", "slow")
                and spec.matches_step(step) and not _fuse_blown(spec, step)):
            _fire(spec, step)


def fire_boot_faults() -> None:
    """The actor boot's hook: fire a crash or hang scripted ``@boot``,
    before the ready line, so the spawner sees a start-up failure. Needs an
    explicit ``TORCHRT_GLOBAL_RANK``."""
    specs = _env_specs()
    if not specs:
        return
    rank = _rank(default=None)
    if rank is None:
        return
    for spec in specs:
        if spec.rank == rank and spec.at == BOOT and not _fuse_blown(spec):
            _fire(spec)


def heartbeats_dropped(step: int) -> bool:
    """The heartbeat's hook: True when a ``drop-heartbeats`` spec of this
    rank is active at ``step`` (silence starts at its step and never
    ends)."""
    specs = _env_specs()
    if not specs:
        return False
    rank = _rank(default=0)
    return any(spec.rank == rank and spec.kind == "drop-heartbeats"
               and isinstance(spec.at, int) and step >= spec.at
               and not _fuse_blown(spec) for spec in specs)


# --------------------------------------------------------------------------
# serving fault points
# --------------------------------------------------------------------------

SERVE_KINDS = ("crash", "hang", "slow-decode", "drop-stream")

_SERVE_SPEC_RE = re.compile(
    r"^replica(?P<replica>\d+):"
    r"(?P<kind>crash|hang|slow-decode|drop-stream)"
    r"@(?:tick(?P<tick>\d+)|req(?P<req>\d+)|every:(?P<every>\d+))"
    r"(?::(?P<arg>[0-9.]+))?$"
)

# the migration kinds share the replica<R> prefix: each of the two parsers
# skips what the other's regex matches
MIGRATION_KINDS = (
    "drop-shipment",
    "corrupt-shipment",
    "stall-shipment",
    "crash-mid-admit",
)

_MIGRATION_SPEC_RE = re.compile(
    r"^replica(?P<replica>\d+):"
    r"(?P<kind>drop-shipment|corrupt-shipment|stall-shipment|crash-mid-admit)"
    r"@(?:req(?P<req>\d+)|every:(?P<every>\d+))"
    r"(?::(?P<arg>[0-9.]+))?$"
)


class ServeFault(RuntimeError):
    """Raised by a serving ``crash`` fault inside the engine loop: an
    exception, not ``os._exit``, so that one engine dies and the process
    (and the journal that recovers its requests) lives on."""


@dataclass(frozen=True)
class ServeFaultSpec:
    """One scripted serving fault for ``replica``. Tick faults (``tick``,
    ``every``) fire at the start of the matching scheduler tick; request
    faults (``req``) fire while admitting the Nth request (1-based, over the
    engine's life). ``arg`` is the slow-decode stall in seconds, or the
    drop-stream budget in generated tokens."""

    replica: int
    kind: str
    tick: Optional[int] = None
    req: Optional[int] = None
    every: Optional[int] = None
    arg: float = 0.0

    @property
    def fuse_id(self) -> str:
        if self.every is not None:
            where = f"every{self.every}"
        elif self.tick is not None:
            where = f"tick{self.tick}"
        else:
            where = f"req{self.req}"
        return f"replica{self.replica}-{self.kind}-{where}"

    def fuse_id_at(self, step: int) -> str:
        if self.every is not None:
            return f"{self.fuse_id}-s{step}"
        return self.fuse_id

    def matches_tick(self, tick: int) -> bool:
        if self.every is not None:
            return tick > 0 and tick % self.every == 0
        return self.tick is not None and self.tick == tick


def parse_serve_faults(text: Optional[str]) -> List[ServeFaultSpec]:
    """Parse the serving specs of a ``TORCHRT_FAULT`` value; rank, arbiter
    and migration specs are skipped. Raises ValueError naming a bad
    ``replica...`` spec."""
    if not text:
        return []
    specs: List[ServeFaultSpec] = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        if _spec_family(raw) not in (None, "replica"):
            continue
        if _MIGRATION_SPEC_RE.match(raw):
            continue
        m = _SERVE_SPEC_RE.match(raw)
        if m is None:
            raise ValueError(
                f"bad {FAULT_ENV} serving spec {raw!r}: expected "
                "replica<R>:<crash|hang|slow-decode|drop-stream>"
                "@<tick<N>|req<N>|every:<N>>[:<arg>] (or a migration kind, "
                "see parse_migration_faults)")
        kind = m.group("kind")
        tick = int(m.group("tick")) if m.group("tick") is not None else None
        req = int(m.group("req")) if m.group("req") is not None else None
        every = int(m.group("every")) if m.group("every") is not None else None
        if every is not None and every < 1:
            raise ValueError(
                f"bad {FAULT_ENV} serving spec {raw!r}: @every needs N >= 1")
        if kind == "drop-stream" and req is None:
            raise ValueError(
                f"bad {FAULT_ENV} serving spec {raw!r}: drop-stream targets "
                "a request, e.g. replica0:drop-stream@req2:4")
        if kind in ("hang", "slow-decode") and req is not None:
            raise ValueError(
                f"bad {FAULT_ENV} serving spec {raw!r}: {kind} is a tick "
                "fault; use @tick<N> or @every:<N>")
        if kind == "slow-decode" and m.group("arg") is None:
            raise ValueError(
                f"bad {FAULT_ENV} serving spec {raw!r}: slow-decode needs a "
                "stall length, e.g. replica0:slow-decode@every:4:0.05")
        specs.append(ServeFaultSpec(
            replica=int(m.group("replica")), kind=kind, tick=tick, req=req,
            every=every, arg=float(m.group("arg") or 0.0)))
    return specs


# the parse of the last value seen, as _cache for the rank family: the
# engine asks once a tick and once an admission
_serve_cache: Tuple[Optional[str], List[ServeFaultSpec]] = (None, [])


def _serve_env_specs() -> List[ServeFaultSpec]:
    global _serve_cache
    text = os.environ.get(FAULT_ENV)
    if text != _serve_cache[0]:
        _serve_cache = (text, parse_serve_faults(text))
    return _serve_cache[1]


def fire_serve_tick_faults(replica: Optional[int], tick: int) -> None:
    """The engine loop's hook at the start of every scheduler tick: crash
    raises :class:`ServeFault` (the loop dies, its completions fail); hang
    blocks the loop thread forever; slow-decode sleeps ``arg`` seconds. A
    no-op when ``replica`` is None or no serving spec is scripted."""
    if replica is None:
        return
    specs = _serve_env_specs()
    if not specs:
        return
    for spec in specs:
        if (spec.replica == replica
                and spec.kind in ("crash", "hang", "slow-decode")
                and spec.req is None and spec.matches_tick(tick)
                and not _fuse_blown(spec, tick)):
            _blow_fuse(spec, tick)
            if spec.kind == "crash":
                raise ServeFault(
                    f"scripted serving fault: replica{replica} crash at "
                    f"tick {tick}")
            if spec.kind == "hang":
                while True:
                    time.sleep(60)
            time.sleep(spec.arg)


def serve_request_fault(replica: Optional[int],
                        req_seq: int) -> Optional[ServeFaultSpec]:
    """The engine's admission hook: ``req_seq`` is the 1-based count of
    requests this engine has admitted. A matching ``crash`` raises
    :class:`ServeFault`; a matching ``drop-stream`` is returned (the engine
    cuts the request's stream after ``spec.arg`` generated tokens)."""
    if replica is None:
        return None
    specs = _serve_env_specs()
    if not specs:
        return None
    for spec in specs:
        if (spec.replica == replica and spec.req is not None
                and spec.req == req_seq and not _fuse_blown(spec)):
            _blow_fuse(spec)
            if spec.kind == "crash":
                raise ServeFault(
                    f"scripted serving fault: replica{replica} crash while "
                    f"admitting request #{req_seq}")
            return spec
    return None


# --------------------------------------------------------------------------
# KV-migration fault points (disaggregated prefill/decode serving)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MigrationFaultSpec:
    """One scripted migration fault for ``replica``. The send-point kinds
    target the Nth shipment leaving the source (1-based);
    ``crash-mid-admit`` the Nth shipment arriving at the destination.
    ``every`` matches every positive multiple of N; ``arg`` is
    ``stall-shipment``'s stall in seconds."""

    replica: int
    kind: str
    req: Optional[int] = None
    every: Optional[int] = None
    arg: float = 0.0

    @property
    def fuse_id(self) -> str:
        where = (f"every{self.every}" if self.every is not None
                 else f"req{self.req}")
        return f"replica{self.replica}-{self.kind}-{where}"

    def fuse_id_at(self, seq: int) -> str:
        if self.every is not None:
            return f"{self.fuse_id}-s{seq}"
        return self.fuse_id

    def matches_seq(self, seq: int) -> bool:
        if self.every is not None:
            return seq > 0 and seq % self.every == 0
        return self.req is not None and self.req == seq


def parse_migration_faults(text: Optional[str]) -> List[MigrationFaultSpec]:
    """Parse the migration specs of a ``TORCHRT_FAULT`` value; rank and
    arbiter specs are skipped by prefix, the engine's serving specs by
    regex. Raises ValueError naming a ``replica...`` spec of neither
    sub-family, as :func:`parse_serve_faults` does."""
    if not text:
        return []
    specs: List[MigrationFaultSpec] = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        if _spec_family(raw) not in (None, "replica"):
            continue
        if _SERVE_SPEC_RE.match(raw):
            continue
        m = _MIGRATION_SPEC_RE.match(raw)
        if m is None:
            raise ValueError(
                f"bad {FAULT_ENV} migration spec {raw!r}: expected "
                "replica<R>:<drop-shipment|corrupt-shipment|stall-shipment|"
                "crash-mid-admit>@<req<N>|every:<N>>[:<seconds>] (or an "
                "engine serving kind, see parse_serve_faults)")
        kind = m.group("kind")
        req = int(m.group("req")) if m.group("req") is not None else None
        every = int(m.group("every")) if m.group("every") is not None else None
        if every is not None and every < 1:
            raise ValueError(
                f"bad {FAULT_ENV} migration spec {raw!r}: @every needs N >= 1")
        if req is not None and req < 1:
            raise ValueError(
                f"bad {FAULT_ENV} migration spec {raw!r}: shipments are "
                "1-based; @req needs N >= 1")
        if kind == "stall-shipment" and m.group("arg") is None:
            raise ValueError(
                f"bad {FAULT_ENV} migration spec {raw!r}: stall-shipment "
                "needs a length, e.g. replica0:stall-shipment@req2:0.5")
        specs.append(MigrationFaultSpec(
            replica=int(m.group("replica")), kind=kind, req=req, every=every,
            arg=float(m.group("arg") or 0.0)))
    return specs


_migration_cache: Tuple[Optional[str], List[MigrationFaultSpec]] = (None, [])


def _migration_env_specs() -> List[MigrationFaultSpec]:
    global _migration_cache
    text = os.environ.get(FAULT_ENV)
    if text != _migration_cache[0]:
        _migration_cache = (text, parse_migration_faults(text))
    return _migration_cache[1]


def migration_send_fault(replica: Optional[int],
                         seq: int) -> Optional[MigrationFaultSpec]:
    """A pump's send-point hook: ``seq`` is the 1-based count of shipments
    that have left source ``replica``. ``stall-shipment`` sleeps ``arg``
    seconds here; ``drop-shipment`` and ``corrupt-shipment`` are returned
    for the caller to simulate where a transport would fail. Returns the
    matching spec (its fuse blown) or None."""
    if replica is None:
        return None
    specs = _migration_env_specs()
    if not specs:
        return None
    for spec in specs:
        if (spec.replica == replica
                and spec.kind in ("drop-shipment", "corrupt-shipment",
                                  "stall-shipment")
                and spec.matches_seq(seq) and not _fuse_blown(spec, seq)):
            _blow_fuse(spec, seq)
            if spec.kind == "stall-shipment":
                time.sleep(spec.arg)
            return spec
    return None


def migration_admit_fault(replica: Optional[int], seq: int) -> None:
    """The receiver's admit-point hook, inside ``import_shipment`` after the
    checksums and before the reservation: ``seq`` is the 1-based count of
    shipments this engine was offered. A matching ``crash-mid-admit``
    raises :class:`ServeFault`: the decode engine dies there."""
    if replica is None:
        return
    specs = _migration_env_specs()
    if not specs:
        return
    for spec in specs:
        if (spec.replica == replica and spec.kind == "crash-mid-admit"
                and spec.matches_seq(seq) and not _fuse_blown(spec, seq)):
            _blow_fuse(spec, seq)
            raise ServeFault(
                f"scripted migration fault: replica{replica} crash while "
                f"admitting shipment #{seq}")
