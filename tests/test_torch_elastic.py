"""Elastic membership of the port (ray_lightning_tpu_torch/runtime/elastic.py,
runtime/supervisor.py's ``on_hung``, launchers/ray_launcher.py's controller
and spare, core/trainer.py's resize), on the CPU.

Against the JAX package: tests/test_elastic.py:137-599's unit cases, each
run on the same scripted events through both packages with the same
outcomes: the supervisor's per-rank verdicts, ``forget_rank`` and
``track_rank``, the ``on_hung`` hook (absorbed and re-armed, rejected,
raising, never consulted without a timeout), the collective-failure
verdicts, the command's round trip, the ledger, the worker agent and the
controller's shrink, re-admission, fallback below ``min_workers``, spawn
failure and deferral of a rank mid-transition. Each package reads its own
variables (``RLT_*`` there, ``TORCHRT_*`` here).

Then real worker groups over gloo with the JAX e2e's assertions
(tests/test_elastic.py:790-850): two workers, rank 1 crashed at step 3 with
``max_failures=0``: the group shrinks to world 1 and a spare forked from the
zygote joins at the next epoch boundary; the worlds are {1, 2}, one survivor
pid runs through every epoch, three processes in all, the last epoch at
world 2, the members' weights bitwise equal, and bitwise equal to one
process that trains the same global batches in order with the group's
arithmetic: each rank's rows in their own backward, the gradients summed
and divided by the world (fp32 AdamW; one backward over the global batch
parts the two at the rounding floor, 1.6e-4 worst, since the sums run in
another order). A real gloo collective against the dead peer is what the
survivor recognizes. A hang is absorbed by ``on_hung`` the same way; under
ZeRO the shrink restores from the checkpoint tier; below ``min_workers``
the relaunch of the ``max_failures`` path runs. The sustained kill loop is
slow, as in JAX. Each group test bounds its workers at 60 s and stops the
runtime in a fixture.
"""
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from ray_lightning_tpu.runtime import elastic as jelastic
from ray_lightning_tpu.runtime import supervisor as jsupervisor
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.callbacks import ModelCheckpoint
from ray_lightning_tpu_torch.core import Trainer
from ray_lightning_tpu_torch.models.llama import LlamaModule, SyntheticLMDataModule
from ray_lightning_tpu_torch.parallel.mesh import MeshSpec
from ray_lightning_tpu_torch.runtime import elastic, faults, supervisor
from ray_lightning_tpu_torch.strategies import RayShardedStrategy, RayStrategy
from ray_lightning_tpu_torch.utils.tree import tree_leaves

import torch_elastic_helpers as eh
import torch_fault_helpers as helpers

TIMEOUT = 60.0

# each package's elastic and supervisor modules, with the rank variable its
# fault module reads
PACKAGES = {
    "jax": (jelastic, jsupervisor, "RLT_GLOBAL_RANK"),
    "port": (elastic, supervisor, faults.RANK_ENV),
}


@pytest.fixture
def clean_env(monkeypatch):
    """No inherited fault, rank or elastic state in either package."""
    for var in ("RLT_FAULT", "RLT_FAULT_FUSE", "RLT_GLOBAL_RANK",
                "RLT_ELASTIC", "RLT_ELASTIC_DIR", "RLT_ELASTIC_JOINER",
                "RLT_MIN_WORKERS", faults.FAULT_ENV, faults.FUSE_ENV,
                faults.RANK_ENV, elastic.ELASTIC_DIR_ENV,
                elastic.ELASTIC_JOINER_ENV):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# --------------------------------------------------------------------- #
# the supervisor: per-rank verdicts and the on_hung hook
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_check_verdicts_are_per_rank(pkg):
    sup_mod = PACKAGES[pkg][1]
    sup = sup_mod.Supervisor(num_workers=2, drain=list, hang_timeout=5.0)
    sup.observe(0, step=4, wall_time=time.time())
    sup.observe(1, step=4, wall_time=time.time())
    base = sup.health[0].last_beat
    sup.health[1].last_beat = base - 10.0
    assert sup.check(now=base + 0.1) == {0: sup_mod.OK, 1: sup_mod.HUNG}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_forget_and_track_rank_rearm_grace(pkg):
    sup_mod = PACKAGES[pkg][1]
    sup = sup_mod.Supervisor(num_workers=2, drain=list, hang_timeout=5.0)
    sup.observe(1, step=3, wall_time=time.time())
    sup.forget_rank(1)
    assert 1 not in sup.health
    sup.forget_rank(1)  # idempotent
    sup.track_rank(1)
    assert sup.health[1].last_beat is None
    assert sup.check(now=time.monotonic() + 100.0)[1] == sup_mod.OK
    sup.forget_rank(1)
    sup.observe(1, step=9, wall_time=time.time())
    assert sup.health[1].last_step == 9


def _silent_rank_supervisor(sup_mod, on_hung):
    """2 ranks; rank 0 keeps beating, rank 1 beats once then goes silent."""
    beats = []
    lock = threading.Lock()

    def drain():
        with lock:
            out, beats[:] = beats[:], []
        return out

    sup = sup_mod.Supervisor(num_workers=2, drain=drain, hang_timeout=0.3,
                             heartbeat_interval=0.05,
                             is_alive=lambda rank: True, on_hung=on_hung)
    return sup, beats, lock


def _feed_until(sup, beats, lock, done, first_rank1=True):
    deadline = time.monotonic() + 5.0
    first = first_rank1
    while time.monotonic() < deadline and not done():
        with lock:
            beats.append((0, 10, time.time()))
            if first:
                beats.append((1, 3, time.time()))
                first = False
        time.sleep(0.02)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_on_hung_absorbs_verdict_and_rearms(pkg, clean_env):
    calls = []
    sup, beats, lock = _silent_rank_supervisor(
        PACKAGES[pkg][1], lambda ranks: calls.append(list(ranks)) or True)
    sup.start()
    try:
        _feed_until(sup, beats, lock, lambda: calls)
        assert calls and calls[0] == [1]
        assert not sup.tripped
        assert 1 not in sup.health and 0 in sup.health
        sup.poll()
        # the rank comes back (one beat), goes silent again: flagged again
        n = len(calls)
        with lock:
            beats.append((1, 4, time.time()))
        _feed_until(sup, beats, lock, lambda: len(calls) > n,
                    first_rank1=False)
        assert len(calls) > n and not sup.tripped
    finally:
        sup.stop()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_on_hung_rejection_falls_back_to_group_trip(pkg, clean_env):
    sup_mod = PACKAGES[pkg][1]
    sup, beats, lock = _silent_rank_supervisor(sup_mod, lambda ranks: False)
    sup.start()
    try:
        _feed_until(sup, beats, lock, lambda: sup.tripped)
        assert sup.tripped
        with pytest.raises(sup_mod.WorkerHangError, match="rank 1"):
            sup.poll()
    finally:
        sup.stop()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_on_hung_exception_is_not_absorption(pkg, clean_env):
    def boom(ranks):
        raise RuntimeError("controller died")

    sup, beats, lock = _silent_rank_supervisor(PACKAGES[pkg][1], boom)
    sup.start()
    try:
        _feed_until(sup, beats, lock, lambda: sup.tripped)
        assert sup.tripped
    finally:
        sup.stop()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_monitor_only_never_consults_on_hung(pkg, clean_env):
    sup_mod = PACKAGES[pkg][1]
    calls = []
    sup = sup_mod.Supervisor(num_workers=1, drain=list, hang_timeout=None,
                             heartbeat_interval=0.05,
                             on_hung=lambda ranks: calls.append(ranks) or True)
    sup.observe(0, step=1, wall_time=time.time())
    sup.start()
    try:
        time.sleep(0.4)
        assert not calls and not sup.tripped
        assert sup.check() == {0: sup_mod.OK}
    finally:
        sup.stop()


# --------------------------------------------------------------------- #
# what counts as a dead peer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("exc,want", [
    (ValueError("Gloo allreduce failed: connection reset by peer"), True),
    (RuntimeError("UNAVAILABLE: rank 1 gone"), True),
    (RuntimeError("coordination service shutting down"), True),
    (ValueError("loss became NaN"), False),
    (KeyError("params"), False),
])
def test_is_collective_failure_markers_match_jax(exc, want):
    assert jelastic.is_collective_failure(exc) == want
    assert elastic.is_collective_failure(exc) == want


@pytest.mark.parametrize("exc", [
    RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:553] "
                 "Connection closed by peer [127.0.0.1]:5015"),
    RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:537] Read "
                 "error [127.0.0.1]:58503: Connection reset by peer"),
    RuntimeError("[../third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:81]"
                 " Timed out waiting 1800000ms for recv operation to complete"),
    torch.distributed.DistBackendError("NCCL communicator was aborted"),
    torch.distributed.DistNetworkError("failed to recv, got 0 bytes"),
], ids=["closed", "reset", "gloo-timeout", "dist-backend", "dist-network"])
def test_torch_dead_peer_errors_are_collective_failures(exc):
    """The errors torch raises on a survivor whose peer died (measured in
    the real two-process group below): by text, or by type (DistError)."""
    assert elastic.is_collective_failure(exc)


# --------------------------------------------------------------------- #
# commands, the ledger and the worker agent
# --------------------------------------------------------------------- #
def _cmd(mod, epoch, kind="shrink", members=(0,), apply="now", **kw):
    return mod.ResizeCommand(epoch=epoch, kind=kind, members=tuple(members),
                             coordinator=f"stub:{epoch}", apply=apply, **kw)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_resize_command_roundtrip(pkg):
    mod = PACKAGES[pkg][0]
    cmd = _cmd(mod, 3, kind="grow", members=(0, 2, 5), apply="epoch_end",
               restore="/ck/last.ckpt", handoff="/led/handoff_000003",
               handoff_writer=0, failed=(1,), reason="re-admit")
    back = mod.ResizeCommand.from_json(cmd.to_json())
    assert back == cmd and back.world == 3
    assert back.rank_of(5) == 2 and back.rank_of(1) is None
    # the two packages' commands carry the same fields
    other = PACKAGES["jax" if pkg == "port" else "port"][0]
    assert other.ResizeCommand.from_json(cmd.to_json()).to_json() == \
        cmd.to_json()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_ledger_announce_ack_handoff(pkg, tmp_path):
    mod = PACKAGES[pkg][0]
    led = mod.MembershipLedger(str(tmp_path / "led"))
    assert not led.has(1) and led.read(1) is None
    led.announce(_cmd(mod, 1, members=(0, 2)))
    assert led.has(1) and led.read(1).members == (0, 2)
    assert not led.acks_present(1, [0, 2])
    led.ack(1, 0)
    assert led.acks_present(1, [0])
    assert not led.wait_acks(1, [0, 2], timeout=0.2)
    led.ack(1, 2)
    assert led.wait_acks(1, [0, 2], timeout=0.2)
    path = led.handoff_path(1)
    w = np.arange(4, dtype=np.float32)
    payload = {"params": {"w": w if pkg == "jax" else torch.from_numpy(w)},
               "meta": {"epoch": 1}}
    mod.write_handoff(path, payload)
    got = mod.read_handoff(path, timeout=1.0)
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]), w)
    assert got["meta"] == {"epoch": 1}
    with pytest.raises(TimeoutError, match="handoff"):
        mod.read_handoff(led.handoff_path(9), timeout=0.2)
    failed = led.handoff_path(2)
    mod.write_handoff_failed(failed)
    assert mod.read_handoff(failed, timeout=30.0, allow_failed=True) is None
    with pytest.raises(TimeoutError):
        mod.read_handoff(failed, timeout=0.2)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_agent_protocol(pkg, tmp_path, clean_env):
    """The latest command wins; an epoch_end command waits for the boundary;
    a survivor waits for its shrink; a joiner waits to be named."""
    mod = PACKAGES[pkg][0]
    led = mod.MembershipLedger(str(tmp_path / "a"))
    led.announce(_cmd(mod, 1, kind="grow", members=(0, 1, 2),
                      apply="epoch_end"))
    led.announce(_cmd(mod, 2, kind="shrink", members=(0, 1), apply="now"))
    agent = mod.ElasticWorkerAgent(led.root, boot_id=0)
    cmd = agent.poll_now()
    assert cmd is not None and cmd.epoch == 2 and cmd.members == (0, 1)
    assert agent.poll_now() is None

    led = mod.MembershipLedger(str(tmp_path / "b"))
    led.announce(_cmd(mod, 1, kind="grow", members=(0, 1, 2),
                      apply="epoch_end"))
    agent = mod.ElasticWorkerAgent(led.root, boot_id=0)
    assert agent.poll_now() is None
    assert agent.poll_epoch_end().epoch == 1
    assert agent.poll_epoch_end() is None

    led = mod.MembershipLedger(str(tmp_path / "c"))
    agent = mod.ElasticWorkerAgent(led.root, boot_id=0)
    assert agent.wait_for_resize(timeout=0.2) is None
    led.announce(_cmd(mod, 1, members=(0,), apply="now"))
    assert agent.wait_for_resize(timeout=5.0).epoch == 1

    led = mod.MembershipLedger(str(tmp_path / "d"))
    agent = mod.ElasticWorkerAgent(led.root, boot_id=2, joiner=True)
    assert agent.is_joiner
    led.announce(_cmd(mod, 1, kind="shrink", members=(0, 1), apply="now"))
    with pytest.raises(TimeoutError, match="boot_id=2"):
        agent.wait_for_join(timeout=0.3)
    led.announce(_cmd(mod, 2, kind="grow", members=(0, 1, 2),
                      apply="epoch_end"))
    cmd = agent.wait_for_join(timeout=5.0)
    assert cmd.epoch == 2 and cmd.rank_of(2) == 2


def test_survivor_waits_at_its_boundary_for_the_grow(tmp_path, clean_env):
    """After a shrink applied now, the first epoch boundary waits (bounded)
    for the grow the main process announces once the shrink is acked, so a
    survivor that re-ran a short epoch does not admit the spare an epoch
    late; a boundary with nothing expected does not wait."""
    led = elastic.MembershipLedger(str(tmp_path))
    agent = elastic.ElasticWorkerAgent(led.root, boot_id=0)
    beats = []
    agent.beat = lambda: beats.append(1)
    t = time.monotonic()
    assert agent.poll_epoch_end() is None and time.monotonic() - t < 0.5
    agent.expect_grow = True
    timer = threading.Timer(0.3, led.announce, args=(_cmd(
        elastic, 1, kind="grow", members=(0, 2), apply="epoch_end"),))
    timer.start()
    cmd = agent.poll_epoch_end()
    timer.join()
    assert cmd is not None and cmd.kind == "grow" and not agent.expect_grow
    assert beats  # it stays alive to the supervisor while it waits
    agent.expect_grow, agent.grow_wait = True, 0.2
    assert agent.poll_epoch_end() is None and not agent.expect_grow


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_worker_agent_from_env(pkg, tmp_path, clean_env):
    mod, _, rank_env = PACKAGES[pkg]
    assert mod.worker_agent_from_env(0) is None
    clean_env.setenv(mod.ELASTIC_DIR_ENV, str(tmp_path))
    agent = mod.worker_agent_from_env(3)
    assert agent is not None and agent.boot_id == 3 and not agent.is_joiner
    clean_env.setenv(mod.ELASTIC_JOINER_ENV, "1")
    clean_env.setenv(rank_env, "5")
    agent = mod.worker_agent_from_env()
    assert agent.boot_id == 5 and agent.is_joiner
    # each package reads only its own variables
    other = PACKAGES["jax" if pkg == "port" else "port"][0]
    assert other.worker_agent_from_env(0) is None


# --------------------------------------------------------------------- #
# the controller
# --------------------------------------------------------------------- #
class _StubHost:
    def __init__(self):
        self.addresses = []

    def new_address(self, num_processes: int) -> str:
        addr = f"127.0.0.1:{9000 + len(self.addresses)}/w{num_processes}"
        self.addresses.append(addr)
        return addr


class _StubAgg:
    def __init__(self):
        self.events = []

    def record_event(self, kind, **fields):
        self.events.append(kind)

    def set_elastic(self, **kw):
        pass


class _StubSupervisor:
    def __init__(self):
        self.forgotten, self.tracked = [], []

    def forget_rank(self, rank, drop_telemetry=False):
        self.forgotten.append(rank)

    def track_rank(self, rank):
        self.tracked.append(rank)


def _controller(pkg, tmp_path, clean_env, *, num_workers=2, min_workers=1,
                spawn=None, readmit=True, find_restore=None):
    mod = PACKAGES[pkg][0]
    clean_env.setenv(mod.ACK_TIMEOUT_ENV, "0.3")
    killed, spawned = [], []

    def default_spawn(boot_id, world_hint):
        spawned.append((boot_id, world_hint))
        return f"fut-{boot_id}"

    kw = dict(ledger=mod.MembershipLedger(str(tmp_path / "ledger")),
              host=_StubHost(), num_workers=num_workers,
              min_workers=min_workers, kill_worker=killed.append,
              spawn_worker=spawn or default_spawn,
              find_restore=find_restore or (lambda: None), readmit=readmit,
              aggregator=_StubAgg())
    ctl = mod.ElasticController(**kw)
    ctl.supervisor = _StubSupervisor()
    return ctl, killed, spawned


def _kinds(pkg, ctl):
    """The events the controller sent its aggregator (the port's also in
    its own ``events``)."""
    if pkg == "port":
        assert [e["event"] for e in ctl.events] == ctl._aggregator.events
    return ctl._aggregator.events


def _fed_controller(pkg, run, clean_env, spawn):
    """A three-worker controller beside its package's own DriverAggregator,
    after a shrink around boot id 1 whose survivors acked it."""
    from ray_lightning_tpu.observability import aggregator as jagg
    from ray_lightning_tpu_torch.observability import aggregator as pagg

    mod = PACKAGES[pkg][0]
    clean_env.setenv(mod.ACK_TIMEOUT_ENV, "0.3")
    agg = (jagg if pkg == "jax" else pagg).DriverAggregator(
        str(run / "telemetry"), num_workers=3)
    ctl = mod.ElasticController(
        ledger=mod.MembershipLedger(str(run / "ledger")), host=_StubHost(),
        num_workers=3, min_workers=1, kill_worker=lambda b: None,
        spawn_worker=spawn, find_restore=lambda: None, aggregator=agg)
    ctl.supervisor = _StubSupervisor()
    ctl._publish()
    ctl.ledger.ack(1, 0)
    ctl.ledger.ack(1, 2)
    assert ctl.handle_failure(1, "process failure: gone") is True
    return ctl, agg


def _record(run):
    import json

    events = [{k: v for k, v in json.loads(line).items() if k != "ts"}
              for line in open(run / "telemetry" / "events.jsonl")]
    bundles = {}
    for bundle in sorted((run / "telemetry" / "incidents").iterdir()):
        ledger = json.loads((bundle / "membership_ledger.json").read_text())
        ledger.pop("last_recovery_s")
        bundles[bundle.name.split("_", 1)[1]] = (
            sorted(p.name for p in bundle.iterdir()), ledger)
    return events, bundles


def test_controller_feeds_a_driver_aggregator_as_jax_s(tmp_path, clean_env):
    """Each package's controller beside its own ``DriverAggregator``: a
    shrink, the spare's grow, its acks, then a crash verdict. The flight
    record's events, the elastic summary and gauges, and the incident
    bundle with the membership ledger's snapshot are JAX's (wall times and
    the recoveries' durations masked)."""
    out = {}
    for pkg in PACKAGES:
        run = tmp_path / pkg
        ctl, agg = _fed_controller(pkg, run, clean_env,
                                   lambda boot_id, world: f"fut-{boot_id}")
        for boot in (0, 2, 3):
            ctl.ledger.ack(2, boot)
        ctl.poll()
        agg.record_event("crash", attempt=0, fatal=True, error="x")
        summary = agg.summary()["elastic"]
        summary.pop("last_recovery_s", None)
        snap = agg.registry.snapshot()
        agg.finalize()
        out[pkg] = (_record(run), summary, snap["gauges"], [
            c for c in snap["counters"] if c[0].startswith("rlt_elastic")])
    assert out["port"] == out["jax"]
    (events, bundles), summary = out["port"][:2]
    assert [e["event"] for e in events] == [
        "elastic_shrink", "elastic_grow_announced", "elastic_grow", "crash"]
    assert summary == {"world_size": 3, "membership_epoch": 2, "shrinks": 1,
                       "grows": 1}
    assert bundles["crash"][1]["members"] == [0, 2, 3]


def test_a_failed_grow_leaves_its_bundle(tmp_path, clean_env):
    """A spare that fails to spawn: the cancelled grow's
    ``elastic_grow_failed`` is an incident, its bundle holding the
    membership ledger. (The JAX controller deadlocks here: it records the
    event under its own non-reentrant lock, and the bundle's ledger
    snapshot takes that lock again; the port's lock is reentrant.)"""

    def bad_spawn(boot_id, world_hint):
        raise RuntimeError("no capacity")

    ctl, agg = _fed_controller("port", tmp_path, clean_env, bad_spawn)
    agg.finalize()
    events, bundles = _record(tmp_path)
    assert [e["event"] for e in events] == ["elastic_shrink",
                                            "elastic_grow_failed"]
    files, ledger = bundles["elastic_grow_failed"]
    assert "membership_ledger.json" in files
    assert ledger["members"] == [0, 2] and [
        t["kind"] for t in ledger["transitions"]] == ["shrink", "grow",
                                                       "shrink"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_controller_shrink_then_readmit(pkg, tmp_path, clean_env):
    ctl, killed, spawned = _controller(
        pkg, tmp_path, clean_env, find_restore=lambda: "/ck/last.ckpt")
    ctl.ledger.ack(1, 0)
    assert ctl.handle_failure(1, "process failure") is True
    assert killed == [1] and ctl.supervisor.forgotten == [1]
    shrink = ctl.ledger.read(1)
    assert (shrink.kind, shrink.apply, shrink.members, shrink.failed,
            shrink.restore) == ("shrink", "now", (0,), (1,), "/ck/last.ckpt")
    assert shrink.handoff is None and shrink.handoff_writer is None
    grow = ctl.ledger.read(2)
    assert (grow.kind, grow.apply, grow.members, grow.handoff_writer) == (
        "grow", "epoch_end", (0, 2), 0)
    assert grow.handoff == ctl.ledger.handoff_path(2)
    assert spawned == [(2, 2)] and ctl.supervisor.tracked == [2]
    assert ctl.members == [0, 2]
    assert ctl.drain_new_futures() == ["fut-2"]
    assert ctl.drain_new_futures() == []
    assert ctl.resizes == {"shrink": 1, "grow": 0}
    ctl.poll()
    assert ctl.resizes["grow"] == 0
    ctl.ledger.ack(2, 0)
    ctl.ledger.ack(2, 2)
    ctl.poll()
    assert ctl.resizes == {"shrink": 1, "grow": 1}
    assert _kinds(pkg, ctl) == ["elastic_shrink", "elastic_grow_announced",
                                "elastic_grow"]
    fut = object()
    ctl.register_future(fut, 1)
    assert ctl.on_future_failure(fut, RuntimeError("late settle")) is True
    assert not ctl.ledger.has(3)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_controller_below_min_workers_falls_back(pkg, tmp_path, clean_env):
    ctl, killed, spawned = _controller(pkg, tmp_path, clean_env,
                                       num_workers=2, min_workers=2)
    assert ctl.handle_failure(0, "crash") is False
    assert not ctl.ledger.has(1)
    assert ctl.members == [0, 1] and spawned == []
    assert ctl.on_future_failure(object(), RuntimeError("who")) is False


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_controller_spawn_failure_cancels_grow(pkg, tmp_path, clean_env):
    def bad_spawn(boot_id, world_hint):
        raise RuntimeError("no capacity")

    ctl, killed, _ = _controller(pkg, tmp_path, clean_env, spawn=bad_spawn)
    ctl.ledger.ack(1, 0)
    assert ctl.handle_failure(1, "crash") is True
    assert ctl.members == [0]
    grow, cancel = ctl.ledger.read(2), ctl.ledger.read(3)
    assert grow.kind == "grow" and grow.members == (0, 2)
    assert cancel.members == (0,) and cancel.apply == "epoch_end"
    assert "cancelled" in cancel.reason
    assert "elastic_grow_failed" in _kinds(pkg, ctl)
    agent = PACKAGES[pkg][0].ElasticWorkerAgent(ctl.ledger.root, boot_id=0)
    agent.poll_now()
    boundary = agent.poll_epoch_end()
    assert boundary.epoch == 3 and boundary.members == (0,)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_controller_defers_mid_transition_ranks(pkg, tmp_path, clean_env):
    ctl, killed, _ = _controller(pkg, tmp_path, clean_env, readmit=False)
    assert ctl.handle_failure(1, "crash") is True  # no ack: times out
    assert ctl._in_transition(0)
    assert ctl.on_hung([0]) is True  # deferred, not evicted
    assert killed == [1] and ctl.members == [0]
    ctl.ledger.ack(1, 0)
    assert not ctl._in_transition(0)
    assert ctl.on_hung([0]) is False  # the last member: unservable
    assert 0 in killed


def test_a_mesh_the_new_world_cannot_hold_is_refused(tmp_path):
    """An ep group of 2 cannot shrink to one worker: refused before the
    worker leaves its group, with the JAX trainer's form of reason."""
    strategy = RayStrategy(num_workers=2, mesh_spec=MeshSpec(axes={"ep": 2}))
    trainer = Trainer(device="cpu", strategy=strategy, logger=False)
    trainer._elastic_agent = types.SimpleNamespace(boot_id=0)
    cmd = elastic.ResizeCommand(epoch=1, kind="shrink", members=(0,),
                                coordinator="stub:1")
    with pytest.raises(RuntimeError, match="elastic shrink to world 1: the "
                       "mesh .* cannot be rebuilt at this size"):
        trainer._apply_resize(cmd, None, None, err=RuntimeError("peer died"))


# --------------------------------------------------------------------- #
# real worker groups over gloo
# --------------------------------------------------------------------- #
@pytest.fixture
def group_env(monkeypatch, tmp_path):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    for var in (faults.FAULT_ENV, faults.FUSE_ENV, faults.RANK_ENV,
                elastic.ELASTIC_DIR_ENV, elastic.ELASTIC_JOINER_ENV):
        monkeypatch.delenv(var, raising=False)
    probe = tmp_path / "probes"
    probe.mkdir()
    yield monkeypatch, probe
    torch.set_num_threads(prev)
    rt.shutdown()


def _fault(monkeypatch, root, spec):
    monkeypatch.setenv(faults.FAULT_ENV, spec)
    monkeypatch.setenv(faults.FUSE_ENV, str(root / "fuses"))


def _fit(root, probe, strategy, max_epochs=3, ckpt=False):
    cfg = helpers.tiny_config()
    module = LlamaModule(cfg, lr=3e-3, warmup_steps=0, total_steps=12)
    callbacks = [eh.WorldProbe(str(probe))]
    if ckpt:
        callbacks.append(ModelCheckpoint(dirpath=str(root / "ckpts"),
                                         save_last=True))
    trainer = Trainer(device="cpu", strategy=strategy, max_epochs=max_epochs,
                      logger=False, seed=0, default_root_dir=str(root),
                      limit_train_batches=2, enable_checkpointing=ckpt,
                      callbacks=callbacks)
    trainer.fit(module, datamodule=SyntheticLMDataModule(
        cfg, batch_size=4, n_train=16, n_val=4))
    return trainer, module


def _elastic_asserts(probe, trainer, strategy):
    assert trainer.state.status == "finished"
    assert trainer.current_epoch == 3
    records = eh.read_probes(str(probe))
    assert {r["world"] for r in records} == {1, 2}, records
    (survivor,) = {r["pid"] for r in records if r["world"] == 1}
    assert sorted({r["epoch"] for r in records if r["pid"] == survivor}) == [
        0, 1, 2], records
    last = [r for r in records if r["epoch"] == 2]
    assert {r["world"] for r in last} == {2}
    assert len({r["pid"] for r in last}) == 2
    assert len({r["pid"] for r in records}) == 3
    hashes = eh.read_hashes(str(probe))
    assert len(hashes) == 2 and len(set(hashes.values())) == 1, hashes
    launcher = strategy.launcher
    assert launcher.elastic["resizes"] == {"shrink": 1, "grow": 1}
    assert launcher.failures == []  # no relaunch ever happened
    return survivor


def _bitwise_replay(probe, module):
    """The weights equal one process's that trains the recorded global
    batches in order with the group's arithmetic (``replay_group``)."""
    batches = eh.global_batches(str(probe))
    assert [b["world"] for b in batches] == [2, 2, 2, 1, 1, 2, 2]
    replay = eh.replay_group(LlamaModule(helpers.tiny_config(), lr=3e-3,
                                         warmup_steps=0, total_steps=12),
                             batches, rows=4)
    got = list(tree_leaves(module.params))
    want = list(tree_leaves(replay))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a.detach(), b.detach()), float(
            (a.detach() - b.detach()).abs().max())


def test_elastic_shrink_and_regrow_e2e(tmp_path, group_env):
    """Rank 1 crashes at step 3 (epoch 1's second batch) with elastic=True
    and max_failures=0: the survivor's gloo all-reduce fails against the
    dead peer, the group shrinks to world 1 in the same process, re-runs
    epoch 1, and a spare forked from the zygote joins at its end; every
    JAX e2e assertion holds, and the weights are bitwise one process's on
    the recorded global batches."""
    monkeypatch, probe = group_env
    _fault(monkeypatch, tmp_path, "rank1:crash@step3")
    strategy = RayStrategy(num_workers=2, timeout_s=TIMEOUT, elastic=True,
                           min_workers=1, max_failures=0, hang_timeout=15.0,
                           heartbeat_interval=0.1)
    trainer, module = _fit(tmp_path, probe, strategy)
    assert os.path.exists(tmp_path / "fuses" / "rank1-crash-at3")
    _elastic_asserts(probe, trainer, strategy)
    assert trainer.global_step == 7
    events = strategy.launcher.elastic["events"]
    assert [e["event"] for e in events] == [
        "elastic_shrink", "elastic_grow_announced", "elastic_grow"]
    assert "process failure" in events[0]["reason"]
    logs = [r for log in strategy.launcher.elastic["worker_logs"] for r in log]
    shrink = next(r for r in logs if r["kind"] == "shrink")
    assert shrink["tier"] == "salvage" and "Connection" in shrink["failure"]
    join = next(r for r in logs if r["kind"] == "join")
    assert join["world"] == 2 and "handoff_read_s" in join
    assert strategy.launcher.timings["spare_spawn_s"] < 5.0
    _bitwise_replay(probe, module)


def test_hang_is_absorbed_by_on_hung(tmp_path, group_env):
    """Rank 1 hangs at step 3: the survivor keeps beating while its
    all-reduce waits, so only rank 1 goes silent; the supervisor's verdict
    goes to the controller, which kills it and shrinks; the spare joins at
    the next boundary. No relaunch, no group trip."""
    monkeypatch, probe = group_env
    _fault(monkeypatch, tmp_path, "rank1:hang@step3")
    strategy = RayStrategy(num_workers=2, timeout_s=TIMEOUT, elastic=True,
                           min_workers=1, max_failures=0, hang_timeout=2.0,
                           heartbeat_interval=0.2)
    trainer, module = _fit(tmp_path, probe, strategy)
    _elastic_asserts(probe, trainer, strategy)
    events = strategy.launcher.elastic["events"]
    assert events[0]["event"] == "elastic_shrink"
    assert events[0]["reason"] == "hang verdict"
    _bitwise_replay(probe, module)


def test_zero_shrink_restores_from_the_checkpoint_tier(tmp_path, group_env):
    """Under ZeRO the dead rank's shards are gone: the survivor restores
    the checkpoint the main process pinned (the epoch-0 save), and the grow
    at the next boundary hands over the whole state gathered by the
    healthy group."""
    monkeypatch, probe = group_env
    _fault(monkeypatch, tmp_path, "rank1:crash@step3")
    strategy = RayShardedStrategy(num_workers=2, zero_stage=2,
                                  timeout_s=TIMEOUT, elastic=True,
                                  min_workers=1, max_failures=0)
    trainer, module = _fit(tmp_path, probe, strategy, ckpt=True)
    _elastic_asserts(probe, trainer, strategy)
    logs = [r for log in strategy.launcher.elastic["worker_logs"] for r in log]
    shrink = next(r for r in logs if r["kind"] == "shrink")
    grow = next(r for r in logs if r["kind"] == "grow")
    assert shrink["tier"] == "checkpoint" and grow["tier"] == "salvage"
    assert grow["handoff_bytes"] > 0
    # restored at the epoch-0 checkpoint (step 2): epoch 1 re-runs from it
    assert trainer.global_step == 6


def test_below_min_workers_relaunches_from_the_checkpoint(tmp_path, group_env):
    """min_workers=2: one survivor is too few, the controller declines and
    the max_failures relaunch runs from the newest checkpoint."""
    monkeypatch, probe = group_env
    _fault(monkeypatch, tmp_path, "rank1:crash@step3")
    strategy = RayStrategy(num_workers=2, timeout_s=TIMEOUT, elastic=True,
                           min_workers=2, max_failures=1)
    trainer, _ = _fit(tmp_path, probe, strategy, ckpt=True)
    (failure,) = strategy.launcher.failures
    assert failure["error"] == "ActorError" and failure["resume"].endswith(
        ".ckpt")
    assert strategy.launcher.elastic["resizes"] == {"shrink": 0, "grow": 0}
    assert {r["world"] for r in eh.read_probes(str(probe))} == {2}
    assert (trainer.current_epoch, trainer.global_step) == (3, 6)
    assert len({r["pid"] for r in eh.read_probes(str(probe))}) == 4


@pytest.mark.slow
def test_sustained_kill_loop(tmp_path, group_env):
    """Whoever holds logical rank 1 dies at every third step: the original
    worker first, then the spares, since fault specs target the logical
    rank after a resize. Every death is absorbed (max_failures=0)."""
    monkeypatch, probe = group_env
    _fault(monkeypatch, tmp_path, "rank1:crash@every:3")
    strategy = RayStrategy(num_workers=2, timeout_s=TIMEOUT, elastic=True,
                           min_workers=1, max_failures=0, hang_timeout=20.0,
                           heartbeat_interval=0.1)
    trainer, _ = _fit(tmp_path, probe, strategy, max_epochs=4)
    assert trainer.state.status == "finished" and trainer.current_epoch == 4
    assert strategy.launcher.elastic["resizes"]["shrink"] >= 2
    assert strategy.launcher.failures == []
    fuses = os.listdir(tmp_path / "fuses")
    assert len([f for f in fuses if f.startswith("rank1-crash-every3-s")]) >= 2
