"""Fault injection, the hang supervisor, the session's heartbeats and the
relaunch of a failed worker group (ray_lightning_tpu_torch/runtime/
faults.py, runtime/supervisor.py, session.py, launchers/ray_launcher.py),
on the CPU.

Against the JAX package (tests/test_chaos.py's cases): the spec grammar on
the same strings gives equal specs or both raise; the fuse, the step and
boot rank rules and ``heartbeats_dropped`` act alike, each package under
its own variables (``RLT_*`` there, ``TORCHRT_*`` here); the supervisor's
verdicts on a fake clock, its clamp of ``hang_timeout``, its straggler
warning; the session's throttle; the strategies' knobs.

Then real worker groups over gloo, as tests/test_chaos.py:447-610 drives
the JAX ones: a fused crash resumes from the run's checkpoint and ends on
weights bitwise equal to an uninjected fit; a hang is detected within
``hang_timeout`` plus two heartbeat intervals, the group killed and
relaunched; ``max_failures=0`` raises ``WorkerHangError``; a stale
checkpoint of an earlier run is ignored; a boot crash is retried; a user
exception is not; a crash inside a tune trial relaunches there
(tests/test_tune.py::test_tune_trial_relaunch_resumes_from_checkpoint), and
the tune hang sweep counts toward ``max_failures``. Each group test bounds
its workers at 60 s (``timeout_s``), uses ``hang_timeout`` 2 s with beats
every 0.5 s, and stops the runtime in a ``finally`` block.
"""
import logging
import os
import threading
import time

import pytest
import torch

from ray_lightning_tpu.runtime import faults as jfaults
from ray_lightning_tpu.runtime import supervisor as jsupervisor
from ray_lightning_tpu.session import RayLightningSession as JSession
from ray_lightning_tpu.strategies.ray_strategies import RayStrategy as JRayStrategy
from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch import tune
from ray_lightning_tpu_torch.callbacks import ModelCheckpoint
from ray_lightning_tpu_torch.core import Trainer
from ray_lightning_tpu_torch.launchers.ray_launcher import _exited
from ray_lightning_tpu_torch.models.llama import LlamaModule, SyntheticLMDataModule
from ray_lightning_tpu_torch.runtime import faults
from ray_lightning_tpu_torch.runtime import supervisor
from ray_lightning_tpu_torch.runtime.supervisor import (
    HUNG,
    OK,
    SLOW,
    Supervisor,
    WorkerHangError,
    WorkerHealth,
    classify,
)
from ray_lightning_tpu_torch.session import RayLightningSession
from ray_lightning_tpu_torch.strategies import RayShardedStrategy, RayStrategy
from ray_lightning_tpu_torch.utils.tree import tree_leaves

import torch_fault_helpers as helpers

TIMEOUT = helpers.TIMEOUT
HANG_TIMEOUT, BEAT = 2.0, 0.5

# each package's fault module with the variables it reads
PACKAGES = {
    "jax": (jfaults, "RLT_GLOBAL_RANK"),
    "port": (faults, faults.RANK_ENV),
}


@pytest.fixture
def clean_fault_env(monkeypatch):
    """No inherited spec, rank or fuse in either package."""
    for mod, rank_env in PACKAGES.values():
        monkeypatch.delenv(mod.FAULT_ENV, raising=False)
        monkeypatch.delenv(mod.FUSE_ENV, raising=False)
        monkeypatch.delenv(rank_env, raising=False)
    return monkeypatch


# --------------------------------------------------------------------- #
# the grammar, against the JAX package
# --------------------------------------------------------------------- #
def _specs(mod, text):
    return [(s.rank, s.kind, s.at, s.seconds, s.every, s.fuse_id)
            for s in mod.parse_faults(text)]


@pytest.mark.parametrize("text", [
    "rank1:hang@step3, rank0:slow@step2:1.5,rank2:drop-heartbeats,rank0:crash@boot",
    "rank1:crash@every:5",
    "rank0:drop-heartbeats@step2",
    "rank3:hang@boot",
    # another family's specs are skipped by the rank parser
    "rank0:crash@step3,replica0:crash@tick8,arbiter:stall@transfer1:0.5",
    "", None,
])
def test_parse_faults_matches_jax(text):
    assert _specs(faults, text) == _specs(jfaults, text)
    if text and "rank1:hang" in text:
        assert _specs(faults, text)[0] == (1, "hang", 3, 0.0, None,
                                           "rank1-hang-at3")


@pytest.mark.parametrize("bad", [
    "rank0:explode@step1", "crash@step3", "rank0:crash", "rank0:hang",
    "rank0:slow@step2", "rank0:slow@boot:1.5", "rank0:drop-heartbeats@boot",
    "rank0:crash@step-3", "rank0:crash@every:0",
    "rank0:drop-heartbeats@every:2",
])
def test_parse_faults_rejects_malformed_as_jax(bad):
    for mod in (faults, jfaults):
        with pytest.raises(ValueError, match="spec"):
            mod.parse_faults(bad)


# --------------------------------------------------------------------- #
# firing, against the JAX package
# --------------------------------------------------------------------- #
def _step_sequence(env, mod, rank_env):
    exits = []
    env.setattr(mod.os, "_exit", lambda code: exits.append(code))
    env.setenv(mod.FAULT_ENV, "rank1:crash@step5")
    mod.fire_step_faults(5)  # no rank: rank 0
    seen = [list(exits)]
    env.setenv(rank_env, "1")
    mod.fire_step_faults(4)
    seen.append(list(exits))
    mod.fire_step_faults(5)
    seen.append(list(exits))
    return seen


def test_step_fault_matches_rank_and_step(clean_fault_env):
    got = {name: _step_sequence(clean_fault_env, *pkg)
           for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"] == [[], [], [1]]


def _fuse_sequence(env, mod, tmp_path, name):
    sleeps = []
    env.setattr(mod.time, "sleep", lambda s: sleeps.append(s))
    env.setenv(mod.FAULT_ENV, "rank0:slow@step2:1.25,rank0:slow@every:3:0.5")
    env.setenv(mod.FUSE_ENV, str(tmp_path / name))
    for step in (2, 2, 3, 3, 6):
        mod.fire_step_faults(step)
    markers = sorted(os.listdir(tmp_path / name))
    env.delenv(mod.FUSE_ENV)
    mod.fire_step_faults(2)  # without a fuse: a pure function of the step
    return sleeps, markers


def test_fuse_makes_faults_fire_at_most_once(clean_fault_env, tmp_path):
    got = {name: _fuse_sequence(clean_fault_env, mod, tmp_path, name)
           for name, (mod, _) in PACKAGES.items()}
    assert got["port"] == got["jax"]
    sleeps, markers = got["port"]
    assert sleeps == [1.25, 0.5, 0.5, 1.25]
    assert markers == ["rank0-slow-at2", "rank0-slow-every3-s3",
                       "rank0-slow-every3-s6"]


def _boot_sequence(env, mod, rank_env):
    exits = []
    env.setattr(mod.os, "_exit", lambda code: exits.append(code))
    env.setenv(mod.FAULT_ENV, "rank0:crash@boot")
    mod.fire_boot_faults()  # no rank: never a boot fault
    seen = [list(exits)]
    env.setenv(rank_env, "1")
    mod.fire_boot_faults()
    seen.append(list(exits))
    env.setenv(rank_env, "0")
    mod.fire_boot_faults()
    seen.append(list(exits))
    return seen


def test_boot_faults_require_explicit_rank(clean_fault_env):
    got = {name: _boot_sequence(clean_fault_env, *pkg)
           for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"] == [[], [], [1]]


def _dropped_sequence(env, mod, rank_env):
    env.setenv(mod.FAULT_ENV, "rank0:drop-heartbeats@step2")
    out = [mod.heartbeats_dropped(s) for s in (0, 1, 2, 7)]
    env.setenv(rank_env, "1")
    return out + [mod.heartbeats_dropped(7)]


def test_heartbeats_dropped_window(clean_fault_env):
    got = {name: _dropped_sequence(clean_fault_env, *pkg)
           for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"] == [False, False, True, True, False]


def test_the_port_reads_only_its_own_variables(clean_fault_env):
    """An ``RLT_FAULT`` spec never fires in the port."""
    exits = []
    clean_fault_env.setattr(faults.os, "_exit", lambda code: exits.append(code))
    clean_fault_env.setenv("RLT_FAULT", "rank0:crash@step1")
    clean_fault_env.setenv("RLT_GLOBAL_RANK", "0")
    faults.fire_step_faults(1)
    assert exits == []
    assert (faults.FAULT_ENV, faults.FUSE_ENV, faults.RANK_ENV) == (
        "TORCHRT_FAULT", "TORCHRT_FAULT_FUSE", "TORCHRT_GLOBAL_RANK")


# --------------------------------------------------------------------- #
# the supervisor, against the JAX package
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("now,last_beat", [
    (1e9, None), (131.0, None), (200.5, 200.0), (202.4, 200.0),
    (203.0, 200.0), (205.0, 200.0), (205.5, 200.0),
])
def test_classify_verdicts_match_jax(now, last_beat):
    """The same verdicts (the JAX supervisor's optional startup_timeout is
    not ported: silence before the first beat is ok)."""
    verdicts = []
    for mod in (supervisor, jsupervisor):
        h = mod.WorkerHealth(rank=0, started=100.0)
        h.last_beat = last_beat
        verdicts.append(mod.classify(h, now=now, hang_timeout=5.0))
    assert verdicts[0] == verdicts[1]
    h = WorkerHealth(rank=0, started=100.0)
    assert classify(h, now=1e9, hang_timeout=5.0) == OK
    h.last_beat = 200.0
    assert [classify(h, t, 5.0) for t in (200.5, 203.0, 205.5)] == [
        OK, SLOW, HUNG]


def test_supervisor_check_warns_straggler_once(caplog):
    for mod in (supervisor, jsupervisor):
        sup = mod.Supervisor(num_workers=1, drain=list, hang_timeout=10.0)
        sup.observe(0, step=3, wall_time=time.time())
        beat = sup.health[0].last_beat
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            assert sup.check(now=beat + 6.0) == {0: mod.SLOW}
            assert sup.check(now=beat + 7.0) == {0: mod.SLOW}
        assert sum("straggling" in r.message for r in caplog.records) == 1
        assert sup.health[0].warned_slow
        # a fresh beat ends the incident and re-arms the warning
        sup.observe(0, step=4, wall_time=time.time())
        assert not sup.health[0].warned_slow
        assert sup.check(now=sup.health[0].last_beat + 1.0) == {0: mod.OK}


def test_supervisor_clamps_timeout_to_heartbeat_interval():
    for mod in (supervisor, jsupervisor):
        sup = mod.Supervisor(num_workers=1, drain=list, hang_timeout=0.1,
                             heartbeat_interval=2.0)
        assert sup.hang_timeout == 4.0
        assert mod.Supervisor(num_workers=1, drain=list,
                              hang_timeout=0).hang_timeout is None


def test_supervisor_trips_only_on_armed_silent_rank():
    """Rank 0 keeps beating, rank 1 beats once then goes silent: only rank 1
    trips, the verdict names its last step, and the kill runs after the
    verdict is readable (the launcher's wait relies on that order)."""
    beats, lock, seen_at_kill = [], threading.Lock(), {}

    def drain():
        with lock:
            out, beats[:] = beats[:], []
        return out

    sup = Supervisor(num_workers=2, drain=drain, hang_timeout=0.3,
                     heartbeat_interval=0.05,
                     kill_group=lambda: seen_at_kill.update(tripped=sup.tripped),
                     is_alive=lambda rank: True)
    sup.start()
    try:
        deadline = time.monotonic() + 5.0
        first = True
        while time.monotonic() < deadline and not sup.tripped:
            with lock:
                beats.append((0, 10, time.time()))
                if first:
                    beats.append((1, 3, time.time()))
                    first = False
            time.sleep(0.02)
        assert sup.tripped
        with pytest.raises(WorkerHangError) as ei:
            sup.poll()
        msg = str(ei.value)
        assert "rank 1" in msg and "last step 3" in msg and "rank 0" not in msg
        assert ei.value.is_process_failure
        assert seen_at_kill == {"tripped": True}
        assert set(sup.silence_at_trip) == {1}
        assert sup.silence_at_trip[1] > 0.3
    finally:
        sup.stop()


def test_supervisor_leaves_dead_processes_to_crash_path():
    killed = []
    sup = Supervisor(num_workers=1, drain=list, hang_timeout=0.1,
                     heartbeat_interval=0.05, kill_group=lambda: killed.append(1),
                     is_alive=lambda rank: False)
    sup.observe(0, step=1, wall_time=time.time())
    sup.start()
    try:
        time.sleep(0.5)
        assert not sup.tripped and not killed
        sup.poll()
    finally:
        sup.stop()


def test_supervisor_never_trips_before_first_heartbeat():
    sup = Supervisor(num_workers=2, drain=list, hang_timeout=0.1,
                     heartbeat_interval=0.05)
    sup.start()
    try:
        time.sleep(0.4)
        assert not sup.tripped
    finally:
        sup.stop()


def test_done_beat_ends_the_watch():
    """A rank whose stage returned (a beat of step -1) is not watched while
    its results go back, however long that takes."""
    sup = Supervisor(num_workers=2, drain=list, hang_timeout=1.0,
                     heartbeat_interval=0.1)
    sup.ingest((0, 4, time.time()))
    sup.ingest((1, 4, time.time()))
    sup.ingest((1, supervisor.DONE, time.time()))
    sup.ingest(("malformed",))
    assert set(sup.health) == {0} and set(sup.finished) == {1}
    now = sup.health[0].last_beat + 5.0
    assert sup.check(now=now) == {0: HUNG}


class _Tap:
    """An aggregator that records what the supervisor hands it."""

    def __init__(self, fail=False):
        self.beats, self.ages, self.events = [], [], []
        self.fail = fail

    def on_beat(self, rank, step, wall_time, payload):
        self.beats.append((rank, step, wall_time, payload))
        if self.fail:
            raise RuntimeError("a broken tap")

    def heartbeat_age(self, rank, age):
        self.ages.append((rank, round(age, 6)))
        if self.fail:
            raise RuntimeError("a broken tap")

    def record_event(self, kind, **fields):
        self.events.append((kind, fields))
        if self.fail:
            raise RuntimeError("a broken tap")


@pytest.mark.parametrize("fail", [False, True], ids=["tap", "broken_tap"])
def test_supervisor_aggregator_tap_matches_jax(fail):
    """Beats of three and of four fields reach ``on_beat`` (the payload, or
    None), every armed rank's beat age reaches ``heartbeat_age`` at a
    check, and a straggler reaches ``record_event``; in both packages
    alike, and a tap that raises never breaks supervision."""
    got = {}
    for mod in (supervisor, jsupervisor):
        tap = _Tap(fail)
        sup = mod.Supervisor(num_workers=2, drain=list, hang_timeout=10.0,
                             label="serve-replicas", aggregator=tap)
        sup.ingest((0, 3, 100.0))
        sup.ingest((1, 5, 101.0, {"load": {"queue_depth": 2}}))
        sup.ingest(("malformed",))
        beat0, beat1 = sup.health[0].last_beat, sup.health[1].last_beat
        verdicts = sup.check(now=beat0 + 6.0)
        assert verdicts[0] == mod.SLOW
        ages = {r: a for r, a in tap.ages}
        assert ages[0] == round(6.0, 6)
        assert ages[1] == round(beat0 + 6.0 - beat1, 6)
        assert sup.health[1].last_step == 5
        events = [(k, f["rank"], f["label"], f["last_step"])
                  for k, f in tap.events]
        got[mod] = (tap.beats, events)
    assert got[supervisor] == got[jsupervisor]
    beats, events = got[supervisor]
    assert beats == [(0, 3, 100.0, None),
                     (1, 5, 101.0, {"load": {"queue_depth": 2}})]
    assert events == [("straggler", 0, "serve-replicas", 3),
                      ("straggler", 1, "serve-replicas", 5)]


def test_supervisor_records_the_hang_with_the_tap():
    tap = _Tap()
    sup = Supervisor(num_workers=1, drain=list, hang_timeout=0.1,
                     heartbeat_interval=0.05, aggregator=tap)
    sup.observe(0, step=7, wall_time=time.time())
    sup._trip([0])
    assert sup.tripped
    assert tap.events[-1][0] == "hang"
    assert tap.events[-1][1]["ranks"] == [0]
    assert tap.events[-1][1]["last_steps"] == {0: 7}
    sup.forget_rank(0, drop_telemetry=True)  # no drop_rank: ignored
    assert 0 not in sup.health


def test_training_supervisor_without_a_tap_is_unchanged():
    """No aggregator (the training paths): a four-field beat is taken as a
    beat, DONE keeps its meaning, and the verdicts are as before."""
    sup = Supervisor(num_workers=2, drain=list, hang_timeout=1.0,
                     heartbeat_interval=0.1)
    assert sup._aggregator is None
    sup.ingest((0, 4, time.time(), {"load": {}}))
    sup.ingest((1, 2, time.time()))
    sup.ingest((1, supervisor.DONE, time.time(), None))
    assert set(sup.health) == {0} and set(sup.finished) == {1}
    assert sup.health[0].last_step == 4
    assert sup.check(now=sup.health[0].last_beat + 0.2) == {0: OK}
    assert sup.check(now=sup.health[0].last_beat + 5.0) == {0: HUNG}
    sup.forget_rank(0, drop_telemetry=True)
    assert sup.health == {}


# --------------------------------------------------------------------- #
# the session's heartbeats and the strategies' knobs
# --------------------------------------------------------------------- #
def _session_sequence(env, cls, mod, rank_env):
    puts = []

    class Channel:
        def put(self, item, timeout=None):
            puts.append(item[:2])

    sess = cls(rank=2, queue=None, heartbeat=Channel(), heartbeat_interval=60.0)
    sess.heartbeat(0)
    sess.heartbeat(1)  # throttled: inside the interval
    sess.heartbeat(1, force=True)
    env.setenv(mod.FAULT_ENV, "rank2:drop-heartbeats@step5")
    env.setenv(rank_env, "2")
    sess.heartbeat(5, force=True)  # dark from step 5 on

    class Dying:
        def put(self, item, timeout=None):
            raise OSError("main process gone")

    cls(rank=0, queue=None, heartbeat=Dying()).heartbeat(0)
    cls(rank=0, queue=None).heartbeat(0)
    return puts


def test_session_heartbeat_throttles_and_never_raises(clean_fault_env):
    port = _session_sequence(clean_fault_env, RayLightningSession,
                             *PACKAGES["port"])
    jax = _session_sequence(clean_fault_env, JSession, *PACKAGES["jax"])
    assert port == jax == [(2, 0), (2, 1)]


def test_checkpoint_write_beats_between_synced_steps(tmp_path, monkeypatch):
    """A checkpoint is written in synced steps with a beat after each, so
    that a write of GBs longer than hang_timeout is not taken for a hang:
    here steps of 64 kB, and the file reads back whole."""
    from ray_lightning_tpu_torch import session
    from ray_lightning_tpu_torch.core import trainer as trainer_mod

    cfg = helpers.tiny_config()
    module = LlamaModule(cfg, lr=3e-3, warmup_steps=0, total_steps=1)
    trainer = Trainer(device="cpu", max_steps=1, logger=False, seed=0,
                      enable_checkpointing=False)
    trainer.fit(module, datamodule=SyntheticLMDataModule(
        cfg, batch_size=2, n_train=2, n_val=2))
    beats = []

    class Channel:
        def put(self, item, timeout=None):
            beats.append(item)

    monkeypatch.setattr(trainer_mod._SyncedFile, "SYNC_BYTES", 64 * 1024)
    session.reset_session()
    session.init_session(rank=0, queue=None, heartbeat=Channel(),
                         heartbeat_interval=0.0)
    try:
        path = str(tmp_path / "c.ckpt")
        trainer.save_checkpoint(path)
        trainer.await_checkpoint_writer()  # one rank: nothing to wait for
    finally:
        session.reset_session()
    # forced before and after, and after synced steps (throttled to one a
    # 10 ms, the session's least interval)
    assert len(beats) >= 3
    assert {b[:2] for b in beats} == {(0, 1)}
    back = torch.load(path, map_location="cpu", weights_only=True)
    for a, b in zip(tree_leaves(back["state_dict"]),
                    tree_leaves(module.params)):
        assert torch.equal(a, b.detach())


def test_strategy_knobs_match_jax(monkeypatch):
    """Supervision is opt-in; constructor values hold; 0 disables; a
    negative value raises ValueError naming the knob (the JAX strategy
    raises when the property is read). No environment variable is read."""
    monkeypatch.delenv("RLT_HANG_TIMEOUT", raising=False)
    monkeypatch.delenv("RLT_HEARTBEAT_INTERVAL", raising=False)
    for cls in (RayStrategy, JRayStrategy):
        s = cls(num_workers=1)
        assert (s.max_failures, s.hang_timeout, s.heartbeat_interval) == (
            0, None, 1.0)
        s = cls(num_workers=1, hang_timeout=7.5, heartbeat_interval=0.2,
                max_failures=3)
        assert (s.max_failures, s.hang_timeout, s.heartbeat_interval) == (
            3, 7.5, 0.2)
        assert cls(num_workers=1, hang_timeout=0).hang_timeout is None
        with pytest.raises(ValueError, match="heartbeat_interval"):
            _ = cls(num_workers=1, heartbeat_interval=-1).heartbeat_interval
        with pytest.raises(ValueError, match="hang_timeout"):
            _ = cls(num_workers=1, hang_timeout=-2).hang_timeout
    monkeypatch.setenv("RLT_HANG_TIMEOUT", "3")
    assert RayStrategy(num_workers=1).hang_timeout is None
    assert RayShardedStrategy(num_workers=2, max_failures=1,
                              hang_timeout=4.0).max_failures == 1


# --------------------------------------------------------------------- #
# real worker groups over gloo
# --------------------------------------------------------------------- #
MAX_EPOCHS, BATCHES = 3, 2  # steps 0-5; a checkpoint at each epoch's end


@pytest.fixture(autouse=True)
def _threads_and_runtime():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
    rt.shutdown()


def _fit(root, strategy, extra=(), max_epochs=MAX_EPOCHS):
    """LlamaConfig.tiny() in fp32 through ``strategy``: two batches of 4
    rows an epoch on each rank, a validation batch and a checkpoint
    (``save_last``) at each epoch's end, rank 0's epoch starts logged to
    ``root/epochs``."""
    cfg = helpers.tiny_config()
    module = LlamaModule(cfg, lr=3e-3, warmup_steps=0,
                         total_steps=max_epochs * BATCHES)
    trainer = Trainer(
        device="cpu", strategy=strategy, max_epochs=max_epochs, logger=False,
        seed=0, default_root_dir=str(root), limit_train_batches=BATCHES,
        limit_val_batches=1,
        callbacks=[ModelCheckpoint(dirpath=str(root / "ckpts"), save_last=True),
                   helpers.EpochLog(str(root / "epochs")),
                   helpers.WorkerPids(str(root / "pids")), *extra])
    trainer.fit(module, datamodule=SyntheticLMDataModule(
        cfg, batch_size=4, n_train=8 * strategy.num_workers, n_val=4))
    return trainer, module


def _no_worker_left(root):
    left = [p for p in helpers.pids_in(str(root / "pids")) if not _exited(p)]
    assert not left, f"worker processes still run: {left}"
    assert not rt.api._state.actors


@pytest.fixture(scope="module")
def uninjected(tmp_path_factory):
    """The fit with no fault: its final weights."""
    root = tmp_path_factory.mktemp("uninjected")
    try:
        trainer, module = _fit(root, RayStrategy(num_workers=1,
                                                 timeout_s=TIMEOUT))
    finally:
        rt.shutdown()
    assert trainer.global_step == MAX_EPOCHS * BATCHES
    return [t.detach().clone() for t in tree_leaves(module.params)]


def _bitwise(module, want):
    got = list(tree_leaves(module.params))
    return len(got) == len(want) and all(
        torch.equal(a.detach(), b) for a, b in zip(got, want))


def test_crash_at_step_resumes_from_fresh_checkpoint(tmp_path, monkeypatch,
                                                     uninjected):
    """rank0:crash@step3 (epoch 1's second batch): the fused crash fires
    once, the relaunch resumes from the epoch-0 checkpoint (epoch 1 runs
    again, epoch 0 does not) and the fit ends at the uninjected final step,
    on its weights, bitwise."""
    monkeypatch.setenv(faults.FAULT_ENV, "rank0:crash@step3")
    monkeypatch.setenv(faults.FUSE_ENV, str(tmp_path / "fuses"))
    strategy = RayStrategy(num_workers=1, max_failures=1, timeout_s=TIMEOUT)
    trainer, module = _fit(tmp_path, strategy)
    assert os.path.exists(tmp_path / "fuses" / "rank0-crash-at3")
    assert helpers.read_epochs(str(tmp_path / "epochs")) == [0, 1, 1, 2]
    assert (trainer.current_epoch, trainer.global_step) == (3, 6)
    (failure,) = strategy.launcher.failures
    assert failure["error"] == "ActorError" and failure["resume"].endswith(
        ".ckpt")
    assert "step=2" in os.path.basename(failure["resume"]) or "last" in \
        failure["resume"]
    assert _bitwise(module, uninjected)
    _no_worker_left(tmp_path)


def test_hang_detected_group_killed_and_relaunched(tmp_path, monkeypatch,
                                                   uninjected):
    """rank0:hang@step3, a real hang: the supervisor sees the silence within
    hang_timeout plus two heartbeat intervals, kills the group and the
    relaunch resumes from the epoch-0 checkpoint, ending on the uninjected
    weights bitwise."""
    monkeypatch.setenv(faults.FAULT_ENV, "rank0:hang@step3")
    monkeypatch.setenv(faults.FUSE_ENV, str(tmp_path / "fuses"))
    strategy = RayStrategy(num_workers=1, max_failures=1, timeout_s=TIMEOUT,
                           hang_timeout=HANG_TIMEOUT, heartbeat_interval=BEAT)
    trainer, module = _fit(tmp_path, strategy)
    marker = tmp_path / "fuses" / "rank0-hang-at3"
    with open(marker) as f:
        hung_at = float(f.read())
    (failure,) = strategy.launcher.failures
    assert failure["error"] == "WorkerHangError"
    assert "hang detected" in failure["message"] and "rank 0" in failure["message"]
    detection = failure["at"] - hung_at
    assert 0 < detection <= HANG_TIMEOUT + 2 * BEAT, detection
    assert failure["silence"][0] > HANG_TIMEOUT
    assert helpers.read_epochs(str(tmp_path / "epochs")) == [0, 1, 1, 2]
    assert (trainer.current_epoch, trainer.global_step) == (3, 6)
    assert _bitwise(module, uninjected)
    _no_worker_left(tmp_path)


def test_hang_with_max_failures_zero_raises(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.FAULT_ENV, "rank0:hang@step1")
    strategy = RayStrategy(num_workers=1, max_failures=0, timeout_s=TIMEOUT,
                           hang_timeout=HANG_TIMEOUT, heartbeat_interval=BEAT)
    with pytest.raises(WorkerHangError, match="hang detected.*rank 0"):
        _fit(tmp_path, strategy, max_epochs=1)
    assert [f["error"] for f in strategy.launcher.failures] == [
        "WorkerHangError"]
    _no_worker_left(tmp_path)


def test_two_rank_hang_kills_the_whole_group(tmp_path, monkeypatch):
    """rank1:hang@step3 of two ranks over gloo: rank 0 waits in the
    gradients' all-reduce, so both go silent; the supervisor kills both and
    the relaunched pair ends at the uninjected final step."""
    monkeypatch.setenv(faults.FAULT_ENV, "rank1:hang@step3")
    monkeypatch.setenv(faults.FUSE_ENV, str(tmp_path / "fuses"))
    strategy = RayStrategy(num_workers=2, max_failures=1, timeout_s=TIMEOUT,
                           hang_timeout=HANG_TIMEOUT, heartbeat_interval=BEAT)
    trainer, _ = _fit(tmp_path, strategy)
    (failure,) = strategy.launcher.failures
    assert failure["error"] == "WorkerHangError"
    assert "hang detected" in failure["message"]
    assert trainer.global_step == 6
    assert len(helpers.pids_in(str(tmp_path / "pids"))) == 4
    _no_worker_left(tmp_path)


def test_relaunch_ignores_stale_pre_run_checkpoint(tmp_path, monkeypatch):
    """A crash before this run saved anything restarts from scratch: a
    leftover .ckpt of an earlier run (garbage bytes, an old mtime) is never
    read."""
    monkeypatch.setenv(faults.FAULT_ENV, "rank0:crash@step1")
    monkeypatch.setenv(faults.FUSE_ENV, str(tmp_path / "fuses"))
    (tmp_path / "ckpts").mkdir()
    stale = tmp_path / "ckpts" / "stale.ckpt"
    stale.write_bytes(b"not a checkpoint")
    past = time.time() - 60
    os.utime(stale, (past, past))
    strategy = RayStrategy(num_workers=1, max_failures=1, timeout_s=TIMEOUT)
    trainer, _ = _fit(tmp_path, strategy)
    assert helpers.read_epochs(str(tmp_path / "epochs")) == [0, 0, 1, 2]
    assert strategy.launcher.failures[0]["resume"] is None
    assert trainer.global_step == 6


def test_crash_at_boot_is_retryable_startup_failure(tmp_path, monkeypatch):
    """rank0:crash@boot fires before the ready line: the spawner sees a
    start-up failure, and the relaunch retries it."""
    monkeypatch.setenv(faults.FAULT_ENV, "rank0:crash@boot")
    monkeypatch.setenv(faults.FUSE_ENV, str(tmp_path / "fuses"))
    strategy = RayStrategy(num_workers=1, max_failures=1, timeout_s=TIMEOUT)
    trainer, module = _fit(tmp_path, strategy, max_epochs=1)
    assert os.path.exists(tmp_path / "fuses" / "rank0-crash-atboot")
    (failure,) = strategy.launcher.failures
    assert "startup failed" in failure["message"]
    assert module.params is not None and trainer.global_step == 2


def test_user_exception_is_not_relaunched(tmp_path):
    """An exception of the stage's own code would fail again in a fresh
    group: it is raised, not retried."""
    strategy = RayStrategy(num_workers=1, max_failures=2, timeout_s=TIMEOUT)
    with pytest.raises(rt.ActorError, match="planted user exception"):
        _fit(tmp_path, strategy, extra=[helpers.RaiseAtStep(1)], max_epochs=1)
    assert len(strategy.launcher.failures) == 1
    _no_worker_left(tmp_path)


# --------------------------------------------------------------------- #
# tune
# --------------------------------------------------------------------- #
def test_tune_trial_relaunch_resumes_from_checkpoint(tmp_path):
    """A worker crash inside a trial relaunches the group there and resumes
    from the checkpoint; the trial still ends TERMINATED
    (tests/test_tune.py's case)."""
    analysis = tune.run(helpers.relaunch_trainable,
                        config={"root": str(tmp_path)}, metric="final_epoch",
                        mode="max", local_dir=str(tmp_path), name="relaunch",
                        verbose=0)
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED", trial.error
    assert trial.last_result["final_epoch"] == 2.0
    assert trial.num_failures == 0
    assert helpers.read_epochs(str(tmp_path / "epochs_trained")) == [0, 1]


def test_tune_hang_sweep_counts_toward_max_failures(tmp_path):
    """A trial that reports once and then hangs: the hang sweep kills it,
    the failure counts toward max_failures, and the retry ends the trial.
    The sweep counts a trial's silence from its start, which includes the
    trial process's imports (seconds here), so its timeout is longer than
    the worker groups'."""
    analysis = tune.run(helpers.hang_once_trainable,
                        config={"root": str(tmp_path)}, metric="loss",
                        mode="min", local_dir=str(tmp_path), name="hang",
                        verbose=0, max_failures=1, hang_timeout=8.0)
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED", trial.error
    assert trial.num_failures == 1
    assert trial.error is None
    assert [r["loss"] for r in trial.results] == [1.0, 1.0, 0.5]
