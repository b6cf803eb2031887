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

The JAX package's ``replica`` (serving and migration) and ``arbiter``
families share the variable there; the port parses no such family yet
(ROADMAP.md, queue 1 items 7-9) and skips their specs, as the JAX rank
parser does.
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
