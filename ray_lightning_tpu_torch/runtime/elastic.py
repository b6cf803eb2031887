"""Elastic membership (``ray_lightning_tpu/runtime/elastic.py``): shrink and
grow a worker group without a relaunch.

On a worker's death (its future settles as a process failure) or a hang
verdict (``Supervisor.on_hung``) the main process keeps the survivors, bumps
a *membership epoch*, hosts a fresh ``torch.distributed.TCPStore`` for it
and announces a :class:`ResizeCommand` through a file-based
:class:`MembershipLedger`. Survivors leave their process group, join a new
one at the new world size and rank through that store, rebuild their
data-parallel engine and go on mid-epoch (the epoch re-runs from its start).
A warm spare, forked from the zygote (``runtime/zygote.py``), is announced
as a ``grow`` applied at the next epoch boundary, where a survivor hands it
the live state.

What the JAX package does with a ``jax.distributed`` coordination service
per membership epoch, the port does with a TCPStore per epoch: the main
process is its master, workers are its clients, and ``init_process_group(
backend, store=..., rank, world_size)`` is the rendezvous. A gloo collective
against a dead peer raises on the survivor (``RuntimeError`` or
``DistBackendError``: "Connection closed by peer", "Connection reset by
peer", a read or write timeout), which :func:`is_collective_failure`
recognizes; that failure is the survivor's signal to wait for the main
process's shrink. ``destroy_process_group`` on a gloo group whose peer died
returns at once, so the survivor destroys its old group; superseded stores
stay referenced in the main process until the group is torn down, as the
JAX package's graveyard keeps superseded services. NCCL is not elastic here:
a dead peer leaves an NCCL survivor waiting until its timeout.

Environment variables, under the port's own prefix: the ledger directory
(``TORCHRT_ELASTIC_DIR``) and whether a worker is a joining spare
(``TORCHRT_ELASTIC_JOINER``) are set by the launcher for its workers; the
waits (``TORCHRT_ELASTIC_WAIT``, ``TORCHRT_ELASTIC_JOIN_TIMEOUT``,
``TORCHRT_ELASTIC_ACK_TIMEOUT``, ``TORCHRT_ELASTIC_CONNECT_TIMEOUT``) have
the JAX package's defaults.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.utils import fsio

logger = logging.getLogger(__name__)

ELASTIC_DIR_ENV = "TORCHRT_ELASTIC_DIR"
ELASTIC_JOINER_ENV = "TORCHRT_ELASTIC_JOINER"

# how long a survivor waits for a shrink after a collective failure before
# it re-raises the failure (and the relaunch path takes over)
RESIZE_WAIT_ENV = "TORCHRT_ELASTIC_WAIT"
_DEFAULT_RESIZE_WAIT = 60.0
# how long a joiner waits to be named in a grow
JOIN_TIMEOUT_ENV = "TORCHRT_ELASTIC_JOIN_TIMEOUT"
_DEFAULT_JOIN_TIMEOUT = 300.0
# the main process's wait for the members' acks of a command
ACK_TIMEOUT_ENV = "TORCHRT_ELASTIC_ACK_TIMEOUT"
_DEFAULT_ACK_TIMEOUT = 120.0
# the rendezvous's bound (the store client's connect, the group's barrier)
CONNECT_TIMEOUT_ENV = "TORCHRT_ELASTIC_CONNECT_TIMEOUT"
_DEFAULT_CONNECT_TIMEOUT = 120.0
# how long a survivor waits at its first epoch boundary after a shrink for
# the grow (or its cancellation) that the main process announces once the
# shrink is acked
GROW_WAIT_S = 10.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name) or default)
    except ValueError:
        return default


class MembershipChanged(Exception):
    """Raised inside the training loop when a resize must apply now."""

    def __init__(self, cmd: "ResizeCommand"):
        super().__init__(f"membership epoch {cmd.epoch}: {cmd.kind} -> world "
                         f"{cmd.world}")
        self.cmd = cmd


_COLLECTIVE_FAILURE_MARKERS = (
    # the JAX package's markers
    "gloo",
    "all-reduce failed",
    "allreduce",
    "all-gather failed",
    "collective",
    "connection reset",
    "connection refused",
    "broken pipe",
    "socket closed",
    "peer closed",
    "unavailable",
    "deadline exceeded",
    "coordination service",
    "distributed runtime",
    "heartbeat",
    # and torch's: gloo's "Connection closed by peer", its timeouts
    "connection closed",
    "timed out",
)


def is_collective_failure(exc: BaseException) -> bool:
    """Whether ``exc`` looks like a dead peer or a broken process group: a
    ``torch.distributed.DistError`` (``DistBackendError``, a store's
    ``DistNetworkError``) is one by type; otherwise the text decides, as in
    the JAX package (gloo's errors cross a C++ boundary as
    ``RuntimeError`` naming the transport)."""
    try:
        from torch.distributed import DistError
    except ImportError:  # pragma: no cover - torch without distributed
        DistError = ()
    if DistError and isinstance(exc, DistError):
        return True
    text = str(exc).lower()
    return any(marker in text for marker in _COLLECTIVE_FAILURE_MARKERS)


# --------------------------------------------------------------------- #
# the rendezvous: a TCPStore per membership epoch
# --------------------------------------------------------------------- #
def elastic_connect(coordinator: str, num_processes: int, process_id: int,
                    backend: str = "gloo",
                    init_timeout: Optional[float] = None,
                    timeout_s: float = 1800.0) -> None:
    """Join the process group of one membership epoch: a client of the
    store at ``coordinator`` ("host:port", hosted by the main process), then
    ``init_process_group`` at this world size and rank. ``timeout_s``
    bounds the group's collectives."""
    import torch.distributed as dist

    if init_timeout is None:
        init_timeout = _env_float(CONNECT_TIMEOUT_ENV, _DEFAULT_CONNECT_TIMEOUT)
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, False,
                          timeout=datetime.timedelta(seconds=init_timeout))
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes,
                            timeout=datetime.timedelta(seconds=timeout_s))


def elastic_disconnect() -> None:
    """Leave the current process group (a gloo group whose peer died is
    destroyed at once)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class StoreHost:
    """The main process's rendezvous host: a fresh TCPStore on a fresh port
    per membership epoch (:meth:`new_address`). Superseded stores stay
    referenced until :meth:`shutdown`, after every worker is gone (the JAX
    package's ``CoordinationHost`` and its graveyard)."""

    def __init__(self, host_ip: str = "127.0.0.1",
                 timeout_s: float = _DEFAULT_CONNECT_TIMEOUT):
        self._host_ip = host_ip
        self._timeout = datetime.timedelta(seconds=timeout_s)
        self._stores: List[Any] = []

    def new_address(self, num_processes: int) -> str:
        import torch.distributed as dist

        store = dist.TCPStore(self._host_ip, 0, num_processes, True,
                              timeout=self._timeout, wait_for_workers=False)
        self._stores.append(store)
        return f"{self._host_ip}:{store.port}"

    def shutdown(self) -> None:
        self._stores = []


# --------------------------------------------------------------------- #
# resize commands and the file ledger
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class ResizeCommand:
    """One membership transition, from the main process to the workers
    through the ledger. ``members`` lists the surviving boot ids (the rank
    a worker was started with, its identity) in the order of their new
    ranks: a worker's rank after the resize is ``members.index(boot_id)``."""

    epoch: int
    kind: str  # "shrink" | "grow"
    members: Tuple[int, ...]
    coordinator: str
    apply: str = "now"  # "now" | "epoch_end"
    restore: Optional[str] = None  # the checkpoint the main process pinned
    handoff: Optional[str] = None  # where the live state is handed over
    handoff_writer: Optional[int] = None  # the boot id that writes it
    failed: Tuple[int, ...] = ()
    reason: str = ""
    ts: float = field(default_factory=time.time)

    @property
    def world(self) -> int:
        return len(self.members)

    def rank_of(self, boot_id: int) -> Optional[int]:
        try:
            return self.members.index(boot_id)
        except ValueError:
            return None

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @staticmethod
    def from_json(raw: str) -> "ResizeCommand":
        data = json.loads(raw)
        data["members"] = tuple(data.get("members") or ())
        data["failed"] = tuple(data.get("failed") or ())
        return ResizeCommand(**data)


class MembershipLedger:
    """Append-only commands and acks in a directory every member can read.
    A command is ``epoch_%06d.json``, written atomically; polling for the
    next one is one ``os.path.exists``, cheap enough for each step."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _cmd_path(self, epoch: int) -> str:
        return os.path.join(self.root, f"epoch_{epoch:06d}.json")

    def announce(self, cmd: ResizeCommand) -> None:
        fsio.atomic_write_bytes(self._cmd_path(cmd.epoch),
                                cmd.to_json().encode(), fsync=True)

    def read(self, epoch: int) -> Optional[ResizeCommand]:
        path = self._cmd_path(epoch)
        try:
            with open(path, encoding="utf-8") as f:
                return ResizeCommand.from_json(f.read())
        except FileNotFoundError:
            return None
        except (ValueError, TypeError):  # pragma: no cover - defensive
            logger.warning("unreadable ledger entry: %s", path)
            return None

    def has(self, epoch: int) -> bool:
        return os.path.exists(self._cmd_path(epoch))

    def _ack_path(self, epoch: int, boot_id: int) -> str:
        return os.path.join(self.root, f"ack_{epoch:06d}_b{boot_id}.json")

    def ack(self, epoch: int, boot_id: int) -> None:
        fsio.atomic_write_bytes(self._ack_path(epoch, boot_id), json.dumps(
            {"ts": time.time(), "pid": os.getpid()}).encode(), fsync=True)

    def acks_present(self, epoch: int, boot_ids: Sequence[int]) -> bool:
        return all(os.path.exists(self._ack_path(epoch, b)) for b in boot_ids)

    def wait_acks(self, epoch: int, boot_ids: Sequence[int],
                  timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.acks_present(epoch, boot_ids):
                return True
            time.sleep(0.05)
        return self.acks_present(epoch, boot_ids)

    def handoff_path(self, epoch: int) -> str:
        return os.path.join(self.root, f"handoff_{epoch:06d}.pt")


def write_handoff(path: str, payload: Dict[str, Any]) -> int:
    """Write the live state (``torch.save``, atomically); returns its
    bytes. Not synced: the members that read it read it within seconds,
    from the page cache, and a handoff does not outlive the group (the
    JAX package syncs it; a GB-sized state then waits on the disk)."""
    import torch

    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        size = f.tell()
    os.replace(tmp, path)
    return size


def write_handoff_failed(path: str) -> None:
    fsio.atomic_write_bytes(path + ".failed", b"{}", fsync=True)


def read_handoff(path: str, timeout: float,
                 allow_failed: bool = False) -> Optional[Dict[str, Any]]:
    """Wait for a handoff file (or, with ``allow_failed``, its failure
    marker: None, and the reader falls back to a checkpoint)."""
    import torch

    deadline = time.monotonic() + timeout
    while True:
        if os.path.exists(path):
            return torch.load(path, map_location="cpu", weights_only=True)
        if allow_failed and os.path.exists(path + ".failed"):
            return None
        if time.monotonic() >= deadline:
            raise TimeoutError(f"timed out waiting for elastic handoff at "
                               f"{path}")
        time.sleep(0.05)


# --------------------------------------------------------------------- #
# the worker's agent
# --------------------------------------------------------------------- #
class ElasticWorkerAgent:
    """A worker's view of the ledger. It scans forward through announced
    commands; when several pile up (a grow superseded by another failure's
    shrink) the latest wins, since every command carries the whole member
    list. ``beat`` (set by the Trainer) is called while it waits, so that
    a waiting survivor stays alive to the hang supervisor."""

    def __init__(self, ledger_dir: str, boot_id: int, joiner: bool = False):
        self.ledger = MembershipLedger(ledger_dir)
        self.boot_id = boot_id
        self.is_joiner = joiner
        self.epoch = 0  # the last applied membership epoch
        self._seen = 0  # the last scanned one
        self._pending: Optional[ResizeCommand] = None
        self.pending_handoff_cmd: Optional[ResizeCommand] = None
        self.failure_wait = _env_float(RESIZE_WAIT_ENV, _DEFAULT_RESIZE_WAIT)
        self.join_timeout = _env_float(JOIN_TIMEOUT_ENV, _DEFAULT_JOIN_TIMEOUT)
        self.grow_wait = GROW_WAIT_S
        # set by a shrink applied now: the main process follows it with a
        # grow (or its cancellation) at the next epoch boundary
        self.expect_grow = False
        self.beat: Optional[Callable[[], None]] = None
        # the process group's backend and its collectives' bound, for each
        # group this worker joins (set by the launcher's wrapping function)
        self.backend = "gloo"
        self.timeout_s = 1800.0

    def _advance(self) -> Optional[ResizeCommand]:
        latest = None
        while self.ledger.has(self._seen + 1):
            cmd = self.ledger.read(self._seen + 1)
            if cmd is None:  # pragma: no cover - a half-visible write
                break
            self._seen += 1
            latest = cmd
        if latest is not None:
            self._pending = latest
        return latest

    def _sleep(self, seconds: float) -> None:
        if self.beat is not None:
            self.beat()
        time.sleep(seconds)

    def poll_now(self) -> Optional[ResizeCommand]:
        """A command to apply at once, if one is pending."""
        self._advance()
        cmd = self._pending
        if cmd is not None and cmd.apply == "now":
            self._pending = None
            return cmd
        return None

    def poll_epoch_end(self) -> Optional[ResizeCommand]:
        """Any pending command, at an epoch boundary (which also applies a
        'now' command that raced the epoch's end). At the first boundary
        after a shrink it waits (up to ``grow_wait``) for the grow that the
        main process announces once the shrink is acked: a survivor that
        re-ran a short epoch before the announcement would otherwise admit
        the spare an epoch late (the JAX agent leaves this to timing)."""
        self._advance()
        if self._pending is None and self.expect_grow:
            deadline = time.monotonic() + self.grow_wait
            while self._pending is None and time.monotonic() < deadline:
                self._sleep(0.01)
                self._advance()
        self.expect_grow = False
        cmd, self._pending = self._pending, None
        return cmd

    def wait_for_resize(self, timeout: Optional[float] = None
                        ) -> Optional[ResizeCommand]:
        """After a collective failure: wait for the main process's shrink."""
        deadline = time.monotonic() + (self.failure_wait if timeout is None
                                       else timeout)
        while time.monotonic() < deadline:
            cmd = self.poll_now()
            if cmd is not None:
                return cmd
            self._sleep(0.05)
        return self.poll_now()

    def wait_for_join(self, timeout: Optional[float] = None) -> ResizeCommand:
        """A joiner: wait until the latest command names this boot id."""
        deadline = time.monotonic() + (self.join_timeout if timeout is None
                                       else timeout)
        while time.monotonic() < deadline:
            self._advance()
            cmd = self._pending
            if cmd is not None and self.boot_id in cmd.members:
                self._pending = None
                return cmd
            self._sleep(0.1)
        raise TimeoutError(f"worker boot_id={self.boot_id} was never admitted "
                           "to the group")

    def connect(self, cmd: ResizeCommand) -> ResizeCommand:
        """Join the rendezvous of ``cmd``; if that fails and a newer command
        (a fresh store) has appeared, join that one instead (never the same
        store again: its rank slots may be half taken). Returns the command
        applied."""
        deadline = time.monotonic() + self.join_timeout
        while True:
            rank = cmd.rank_of(self.boot_id)
            if rank is None:
                raise MembershipChanged(cmd)  # evicted while transitioning
            try:
                elastic_connect(cmd.coordinator, cmd.world, rank,
                                self.backend, timeout_s=self.timeout_s)
            except Exception as exc:
                elastic_disconnect()
                newer = self._await_newer(cmd, deadline)
                if newer is None:
                    raise
                logger.warning("elastic connect to epoch %d failed (%s); "
                               "retrying at epoch %d", cmd.epoch, exc,
                               newer.epoch)
                cmd = newer
                continue
            self.epoch = cmd.epoch
            self.pending_handoff_cmd = cmd if cmd.handoff else None
            self.expect_grow = cmd.kind == "shrink" and cmd.apply == "now"
            return cmd

    def _await_newer(self, cmd: ResizeCommand, deadline: float
                     ) -> Optional[ResizeCommand]:
        while time.monotonic() < deadline:
            latest = self._advance() or self._pending
            if latest is not None and latest.epoch > cmd.epoch:
                self._pending = None
                return latest
            self._sleep(0.1)
        return None

    def reconnect(self, cmd: ResizeCommand) -> ResizeCommand:
        elastic_disconnect()
        return self.connect(cmd)

    def ack(self, cmd: ResizeCommand) -> None:
        self.ledger.ack(cmd.epoch, self.boot_id)


def worker_agent_from_env(boot_id: Optional[int] = None
                          ) -> Optional[ElasticWorkerAgent]:
    """The worker's agent from its environment, or None outside an elastic
    group. The boot id defaults to the rank the worker was started with."""
    ledger_dir = os.environ.get(ELASTIC_DIR_ENV)
    if not ledger_dir:
        return None
    if boot_id is None:
        from ray_lightning_tpu_torch.runtime.faults import RANK_ENV

        boot_id = int(os.environ.get(RANK_ENV, "0"))
    return ElasticWorkerAgent(ledger_dir, boot_id,
                              joiner=os.environ.get(ELASTIC_JOINER_ENV) == "1")


# --------------------------------------------------------------------- #
# the main process's controller
# --------------------------------------------------------------------- #
class ElasticController:
    """Membership control in the main process, between the supervisor and
    the result wait and the launcher: on a worker's death it evicts the dead
    boot id, announces a shrink applied now, then spawns a warm spare and
    announces a grow applied at the next epoch boundary. It declines
    (returns False) when the survivors would be fewer than ``min_workers``,
    and the caller runs the relaunch of the whole group.

    With an ``aggregator`` (``observability/aggregator.py``) every event
    also lands in its flight record, the world size, membership epoch,
    resize counts and recovery times in its gauges, and the membership
    ledger's view (:meth:`_ledger_snapshot`) in every incident bundle."""

    def __init__(self, ledger: MembershipLedger, host: Any, num_workers: int,
                 min_workers: int, kill_worker: Callable[[int], None],
                 spawn_worker: Callable[[int, int], Any],
                 find_restore: Callable[[], Optional[str]],
                 aggregator: Any = None, readmit: bool = True):
        self.ledger = ledger
        self.host = host
        self.min_workers = max(1, int(min_workers))
        self._kill_worker = kill_worker
        self._spawn_worker = spawn_worker
        self._find_restore = find_restore
        self._aggregator = aggregator
        self._readmit = readmit
        self.supervisor: Any = None  # wired by the launcher
        if hasattr(aggregator, "register_incident_source"):
            # incident bundles freeze the membership view at fault time
            aggregator.register_incident_source("membership_ledger",
                                                self._ledger_snapshot)
        self._lock = threading.RLock()
        self.members: List[int] = list(range(num_workers))
        self.epoch = 0
        self._next_boot_id = num_workers
        self._fut_owner: Dict[int, int] = {}
        self._new_futures: List[Any] = []
        # (epoch, members, monotonic time of the announce)
        self._grow_pending: Optional[Tuple[int, Tuple[int, ...], float]] = None
        self._unacked: Dict[int, Tuple[int, ...]] = {}  # epoch -> boot ids
        self.resizes = {"shrink": 0, "grow": 0}
        self.last_recovery_s: Optional[float] = None
        self.events: List[Dict[str, Any]] = []
        self.ack_timeout = _env_float(ACK_TIMEOUT_ENV, _DEFAULT_ACK_TIMEOUT)

    def register_future(self, fut: Any, boot_id: int) -> None:
        self._fut_owner[id(fut)] = boot_id

    def drain_new_futures(self) -> List[Any]:
        out, self._new_futures = self._new_futures, []
        return out

    def on_future_failure(self, fut: Any, err: BaseException) -> bool:
        """A worker's future settled as a process failure: True when the
        group shrank around it (the caller drops the future), False for
        the relaunch path."""
        boot_id = self._fut_owner.get(id(fut))
        if boot_id is None:
            return False
        return self.handle_failure(boot_id, f"process failure: {err}")

    def on_hung(self, ranks: Sequence[int]) -> bool:
        """The supervisor's hang verdict on ``ranks`` (boot ids): kill each
        and shrink around it. A rank in the middle of a transition (a
        command it has not acked: a rendezvous or a rebuild looks like a
        hang) is deferred; the supervisor forgets it and re-arms at its
        next beat."""
        ok = True
        for boot_id in list(ranks):
            if self._in_transition(boot_id):
                logger.info("elastic: rank %d looks hung but is "
                            "mid-transition; deferring", boot_id)
                continue
            # the shrink kills the rank under the controller's lock, so the
            # lost connection that follows finds it evicted already; a
            # declined shrink still kills it (the group trip follows)
            if self.handle_failure(boot_id, "hang verdict"):
                continue
            ok = False
            try:
                self._kill_worker(boot_id)
            except Exception:  # pragma: no cover - a best-effort kill
                logger.warning("elastic: kill of hung rank %d failed",
                               boot_id, exc_info=True)
        return ok

    def _in_transition(self, boot_id: int) -> bool:
        for epoch, boots in list(self._unacked.items()):
            if self.ledger.acks_present(epoch, boots):
                self._unacked.pop(epoch, None)
                continue
            if boot_id in boots and not self.ledger.acks_present(epoch,
                                                                 [boot_id]):
                return True
        return False

    def handle_failure(self, boot_id: int, reason: str) -> bool:
        with self._lock:
            if boot_id not in self.members:
                # already evicted (a killed hung worker's future settling)
                return True
            survivors = [b for b in self.members if b != boot_id]
            if len(survivors) < self.min_workers:
                logger.warning("elastic: %d survivors < min_workers=%d; "
                               "falling back to the relaunch",
                               len(survivors), self.min_workers)
                return False
            t0 = time.monotonic()
            if self.supervisor is not None:
                try:
                    self.supervisor.forget_rank(boot_id, drop_telemetry=True)
                except Exception:  # pragma: no cover
                    pass
            elif self._aggregator is not None:
                try:
                    self._aggregator.drop_rank(boot_id)
                except Exception:  # pragma: no cover
                    pass
            try:
                self._kill_worker(boot_id)
            except Exception:  # pragma: no cover - usually already dead
                pass
            restore = None
            try:
                restore = self._find_restore()
            except Exception:  # pragma: no cover - a best-effort scan
                logger.warning("elastic: checkpoint scan failed",
                               exc_info=True)
            self.epoch += 1
            multi = len(survivors) > 1
            cmd = ResizeCommand(
                epoch=self.epoch, kind="shrink", members=tuple(survivors),
                coordinator=self.host.new_address(len(survivors)),
                apply="now", restore=restore,
                handoff=self.ledger.handoff_path(self.epoch) if multi else None,
                handoff_writer=survivors[0] if multi else None,
                failed=(boot_id,), reason=reason)
            self.ledger.announce(cmd)
            self.members = survivors
            self._unacked[cmd.epoch] = cmd.members
            self._record_event("elastic_shrink", epoch=cmd.epoch,
                               failed=boot_id, world=cmd.world, reason=reason)
            acked = self.ledger.wait_acks(cmd.epoch, cmd.members,
                                          self.ack_timeout)
            recovery = time.monotonic() - t0
            self.resizes["shrink"] += 1
            self.last_recovery_s = recovery
            self._publish(recovery_s=recovery if acked else None)
            if not acked:
                logger.warning("elastic: shrink epoch %d not fully acked "
                               "after %.0fs; continuing", cmd.epoch,
                               self.ack_timeout)
            if self._readmit:
                self._schedule_readmit()
            return True

    def _schedule_readmit(self) -> None:
        joiner = self._next_boot_id
        self._next_boot_id += 1
        new_members = tuple(self.members) + (joiner,)
        self.epoch += 1
        cmd = ResizeCommand(
            epoch=self.epoch, kind="grow", members=new_members,
            coordinator=self.host.new_address(len(new_members)),
            apply="epoch_end", handoff=self.ledger.handoff_path(self.epoch),
            handoff_writer=self.members[0], reason="re-admit")
        self.ledger.announce(cmd)
        try:
            fut = self._spawn_worker(joiner, len(new_members))
        except Exception:
            logger.exception("elastic: spare spawn failed; cancelling the "
                             "re-admit")
            # a same-members command supersedes the grow, so that the
            # survivors do not wait at a rendezvous for a ghost
            self.epoch += 1
            self.ledger.announce(ResizeCommand(
                epoch=self.epoch, kind="shrink", members=tuple(self.members),
                coordinator=self.host.new_address(len(self.members)),
                apply="epoch_end",
                handoff=self.ledger.handoff_path(self.epoch),
                handoff_writer=self.members[0],
                reason="re-admit cancelled: spare spawn failed"))
            self._record_event("elastic_grow_failed", epoch=cmd.epoch,
                               joiner=joiner)
            return
        self.members = list(new_members)
        self._unacked[cmd.epoch] = cmd.members
        self._grow_pending = (cmd.epoch, cmd.members, time.monotonic())
        if self.supervisor is not None:
            try:
                self.supervisor.track_rank(joiner)
            except Exception:  # pragma: no cover
                pass
        self.register_future(fut, joiner)
        self._new_futures.append(fut)
        self._record_event("elastic_grow_announced", epoch=cmd.epoch,
                           joiner=joiner, world=cmd.world)
        self._publish()

    def stranded_joiner(self, futures: Sequence[Any]) -> Optional[int]:
        """The boot id of a spare that no survivor will admit: ``futures``
        (those still running) are the pending grow's joiner's alone, and
        the survivors never acked the grow (they finished first: a grow
        announced after their last epoch boundary). None otherwise."""
        pending = self._grow_pending
        if pending is None or not futures:
            return None
        epoch, boots, _ = pending
        joiner = boots[-1]
        if any(self._fut_owner.get(id(f)) != joiner for f in futures):
            return None
        if self.ledger.acks_present(epoch, boots[:-1]):
            return None  # admitted: it finishes with the group
        return joiner

    def cancel_grow(self, joiner: int) -> None:
        """Take back a grow whose spare was stranded: evict and kill it."""
        with self._lock:
            pending = self._grow_pending
            if pending is None or pending[1][-1] != joiner:
                return
            self._grow_pending = None
            self._unacked.pop(pending[0], None)
            self.members = [b for b in self.members if b != joiner]
            if self.supervisor is not None:
                self.supervisor.forget_rank(joiner)
            try:
                self._kill_worker(joiner)
            except Exception:  # pragma: no cover - a best-effort kill
                pass
            self._record_event("elastic_grow_cancelled", epoch=pending[0],
                               joiner=joiner)

    def poll(self) -> None:
        """A cheap periodic check: a grow completes when every member has
        acked it."""
        pending = self._grow_pending
        if pending is None:
            return
        epoch, boots, t0 = pending
        if self.ledger.acks_present(epoch, boots):
            self._grow_pending = None
            self._unacked.pop(epoch, None)
            recovery = time.monotonic() - t0
            self.resizes["grow"] += 1
            self.last_recovery_s = recovery
            self._record_event("elastic_grow", epoch=epoch, world=len(boots))
            self._publish(recovery_s=recovery)

    def _ledger_snapshot(self) -> Dict[str, Any]:
        """Membership state for an incident bundle: the members, epoch,
        resize counts and last recovery, and the ledger's transitions."""
        with self._lock:
            out: Dict[str, Any] = {
                "members": list(self.members),
                "epoch": self.epoch,
                "resizes": dict(self.resizes),
                "last_recovery_s": self.last_recovery_s,
            }
        cmds = []
        epoch = 1
        while self.ledger.has(epoch):
            cmd = self.ledger.read(epoch)
            if cmd is not None:
                cmds.append({"epoch": cmd.epoch, "kind": cmd.kind,
                             "world": cmd.world, "members": list(cmd.members)})
            epoch += 1
        out["transitions"] = cmds
        return out

    def _record_event(self, kind: str, **detail: Any) -> None:
        self.events.append({"event": kind, "wall": time.time(), **detail})
        if self._aggregator is not None:
            try:
                self._aggregator.record_event(kind, **detail)
            except Exception:  # pragma: no cover
                logger.debug("elastic event emit failed", exc_info=True)

    def _publish(self, recovery_s: Optional[float] = None) -> None:
        """The membership gauges of the aggregator, if there is one."""
        if self._aggregator is None:
            return
        try:
            self._aggregator.set_elastic(
                world_size=len(self.members), membership_epoch=self.epoch,
                shrinks=self.resizes["shrink"], grows=self.resizes["grow"],
                recovery_s=recovery_s)
        except Exception:  # pragma: no cover
            logger.debug("elastic gauge publish failed", exc_info=True)
