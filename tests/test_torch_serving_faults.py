"""The port's serving and migration fault grammars
(ray_lightning_tpu_torch/runtime/faults.py), its resilience pieces
(serving/resilience.py: circuit breaker, request journal, shed policy,
SIGTERM drain) and the engine's fault points, held against the JAX
package's on the same strings, the same scripts and the same tiny model.
The port reads ``TORCHRT_FAULT``, the JAX package ``RLT_FAULT``; the
fixtures arm both with one spec."""
import dataclasses
import os
import signal
import time

import pytest
import torch

from ray_lightning_tpu.runtime import faults as jax_faults
from ray_lightning_tpu.serving import resilience as jax_resilience
from ray_lightning_tpu_torch.runtime import faults as port_faults
from ray_lightning_tpu_torch.serving import resilience as port_resilience
from torch_serving_helpers import (
    fault_env,
    jax_engine,
    port_engine,
    reference,
    tiny_models,
    two_threads,
)

pytestmark = pytest.mark.serving


@pytest.fixture(scope="module")
def model():
    prev = two_threads()
    yield tiny_models()
    torch.set_num_threads(prev)


# --------------------------------------------------------------------- #
# the grammars: the same specs and the same errors
# --------------------------------------------------------------------- #
SPEC_STRINGS = [
    "rank0:crash@step3,replica1:crash@every:6,"
    "replica0:slow-decode@tick4:0.25,replica2:drop-stream@req2:4",
    "replica0:drop-shipment@req1,replica1:corrupt-shipment@every:3,"
    "replica2:stall-shipment@req2:0.5,replica0:crash-mid-admit@req4",
    "replica0:crash@tick3,replica1:corrupt-shipment@req1",
    "replica1:hang@tick5,replica1:crash@req3,arbiter:stall@transfer1:0.5",
    "replica0:crash@every:8,rank1:hang@step2", "", None,
    "replica0:explode@tick3", "replica0:crash@every:0",
    "replica0:drop-stream@tick3", "replica0:hang@req2",
    "replica0:slow-decode@every:4", "replica0:corrupt-shipment",
    "replica0:drop-shipment@req0", "replica0:stall-shipment@req1",
    "replica0:corrupt-shipment@every:0", "bogus:crash@tick1",
    "replica0:crash-mid-admit@every:2:1.5",
]


def _parsed(mod, parse, text):
    try:
        return [(type(s).__name__, dataclasses.asdict(s))
                for s in parse(text)]
    except ValueError as e:
        return ("ValueError", str(e).replace(mod.FAULT_ENV, "<FAULT_ENV>"))


@pytest.mark.parametrize("text", SPEC_STRINGS,
                         ids=[str(i) for i in range(len(SPEC_STRINGS))])
@pytest.mark.parametrize("family", ["serve", "migration"])
def test_fault_grammar_matches_jax(text, family):
    name = f"parse_{family}_faults"
    got = _parsed(port_faults, getattr(port_faults, name), text)
    want = _parsed(jax_faults, getattr(jax_faults, name), text)
    assert got == want


def test_fault_grammar_values():
    specs = port_faults.parse_serve_faults(SPEC_STRINGS[0])
    assert [(s.replica, s.kind) for s in specs] == [
        (1, "crash"), (0, "slow-decode"), (2, "drop-stream")]
    assert specs[0].matches_tick(12) and not specs[0].matches_tick(0)
    assert specs[1].tick == 4 and specs[1].arg == 0.25
    mig = port_faults.parse_migration_faults(SPEC_STRINGS[1])
    assert [s.kind for s in mig] == list(port_faults.MIGRATION_KINDS)
    assert mig[1].matches_seq(3) and mig[1].matches_seq(6)
    # the rank parser skips every replica spec
    assert port_faults.parse_faults(SPEC_STRINGS[1]) == []
    assert [s.kind for s in port_faults.parse_faults(SPEC_STRINGS[0])] == [
        "crash"]


def _send_sequence(mod):
    fired = []
    for replica in (0, 1, 2):
        for seq in range(1, 8):
            spec = mod.migration_send_fault(replica, seq)
            if spec is not None:
                fired.append((replica, seq, spec.kind))
    fired.append(mod.migration_send_fault(None, 1))
    return fired


def test_migration_send_fault_sequence_matches_jax():
    spec = ("replica0:drop-shipment@every:3,replica0:corrupt-shipment@req2,"
            "replica1:stall-shipment@req1:0.01,replica2:crash-mid-admit@req1,"
            "replica1:crash@tick1")
    with fault_env(spec):
        got = _send_sequence(port_faults)
        want = _send_sequence(jax_faults)
    assert got == want
    assert got == [(0, 2, "corrupt-shipment"), (0, 3, "drop-shipment"),
                   (0, 6, "drop-shipment"), (1, 1, "stall-shipment"), None]


def test_admit_and_request_faults_match_jax():
    spec = "replica1:crash-mid-admit@every:2,replica0:drop-stream@req2:3"
    outcomes = {}
    with fault_env(spec):
        for name, mod in (("port", port_faults), ("jax", jax_faults)):
            out = []
            for seq in range(1, 5):
                try:
                    mod.migration_admit_fault(1, seq)
                    out.append("ok")
                except mod.ServeFault as e:
                    out.append(str(e))
                s = mod.serve_request_fault(0, seq)
                out.append(None if s is None else (s.kind, s.arg))
            outcomes[name] = out
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == outcomes["port"][4] == "ok"
    assert outcomes["port"][2].endswith("shipment #2")
    assert outcomes["port"][6].endswith("shipment #4")
    assert outcomes["port"][3] == ("drop-stream", 3.0)


def test_serve_fault_fuse_fires_once(tmp_path):
    with fault_env("replica0:crash@tick2"):
        os.environ[port_faults.FUSE_ENV] = str(tmp_path)
        port_faults.fire_serve_tick_faults(0, 1)
        with pytest.raises(port_faults.ServeFault, match="tick 2"):
            port_faults.fire_serve_tick_faults(0, 2)
        port_faults.fire_serve_tick_faults(0, 2)  # fuse blown: no-op
        port_faults.fire_serve_tick_faults(None, 2)
    assert os.listdir(tmp_path) == ["replica0-crash-tick2"]
    assert port_faults.FUSE_ENV not in os.environ


# --------------------------------------------------------------------- #
# breaker, journal, shed policy, SIGTERM drain: the same script
# --------------------------------------------------------------------- #
def _breaker_script(res):
    clock = [0.0]
    b = res.CircuitBreaker(failure_threshold=3, open_cooldown_s=5.0,
                           clock=lambda: clock[0])
    out = [b.state, b.allow_request()]
    for op in ("f", "f", "s", "f", "f"):
        b.record_failure() if op == "f" else b.record_success()
    out.append(b.state)
    b.record_failure()
    out += [b.state, b.allow_request()]
    for t in (4.9, 5.1):
        clock[0] = t
        out.append(b.allow_request())
    out += [b.state, b.allow_request()]
    b.record_failure()
    out += [b.state, b.allow_request()]
    clock[0] = 11.0
    out.append(b.allow_request())
    b.record_success()
    out += [b.state, b.allow_request(), b.state_value(), b.transitions,
            b.failures_total, b.successes_total]
    try:
        res.CircuitBreaker(failure_threshold=0)
    except ValueError as e:
        out.append(str(e))
    return out


def test_breaker_cycle_matches_jax():
    got = _breaker_script(port_resilience)
    assert got == _breaker_script(jax_resilience)
    arcs = [(frm, to) for _, frm, to in got[-4]]
    assert arcs == [("closed", "open"), ("open", "half_open"),
                    ("half_open", "open"), ("open", "half_open"),
                    ("half_open", "closed")]


class _FakeCompletion:
    done = False


def _journal_script(res):
    journal = res.RequestJournal()
    seen = []
    entry = journal.open((5, 6, 7), 8, request_id="j",
                         on_token=lambda rid, t: seen.append((rid, t)))
    out = [journal.begin_attempt(entry, replica=0)]
    journal.bind(entry, _FakeCompletion())
    out.append(journal.retries_total)
    guard1 = journal.stream_guard(entry, out[0][0])
    guard1("x", 11)
    guard1("x", 12)
    out.append(journal.begin_attempt(entry, replica=1))
    journal.bind(entry, _FakeCompletion())
    out += [journal.retries_total, entry.retries]
    guard1("x", 99)  # the superseded attempt's token lands nowhere
    guard2 = journal.stream_guard(entry, out[2][0])
    guard2("y", 13)
    out.append(journal.begin_attempt(entry, replica=2, migration=True))
    journal.bind(entry, _FakeCompletion())
    journal.restore_attempt(entry, 1, out[2][0], None)
    guard2("y", 14)
    journal.finish(entry, "completed", finish_reason="length")
    guard2("y", 15)
    journal.finish(entry, "failed")  # the first finish wins
    out += [list(entry.delivered), entry.result(), entry.disposition,
            entry.finish_reason, entry.replica_history, entry.attempt_rids,
            entry.migrations, entry.remaining_budget(), seen]
    other = journal.open((1, 2), 4)
    journal.begin_attempt(other, replica=0)
    journal.abort_attempt(other)
    out += [other.attempts, other.attempt_rid,
            journal.begin_attempt(other, replica=1)]
    journal.finish(other, "quota_rejected")
    try:
        journal.open((1,), 2, request_id="j")
    except ValueError as e:
        out.append(str(e))
    try:
        journal.finish(other, "vanished")
    except ValueError as e:
        out.append(str(e))
    out.append(journal.stats())
    return out


def test_journal_arithmetic_and_stream_guard_match_jax():
    got = _journal_script(port_resilience)
    assert got == _journal_script(jax_resilience)
    assert got[0] == ("j", (5, 6, 7), 8)
    assert got[2] == ("j~r1", (5, 6, 7, 11, 12), 6)
    assert got[5] == ("j~m1", (5, 6, 7, 11, 12, 13), 5)
    assert got[6] == [11, 12, 13, 14]
    assert got[-1] == {"completed": 1, "shed": 0, "expired": 0, "failed": 0,
                       "quota_rejected": 1, "retries": 1, "open": 0}


def test_shed_policy_matches_jax():
    for kw in ({}, dict(queue_watermark=0.5, shed_priority_floor=2),
               dict(best_effort_watermark=0.1)):
        grid = [(p, d, b) for p in (0, 1, 2, 5) for d in (0, 10, 50, 70, 90)
                for b in (False, True)]
        port = port_resilience.ShedPolicy(**kw)
        jax = jax_resilience.ShedPolicy(**kw)
        assert [port.should_shed(p, d, 100, slo_breached=b)
                for p, d, b in grid] == [
            jax.should_shed(p, d, 100, slo_breached=b) for p, d, b in grid]
    assert port_resilience.DISPOSITIONS == jax_resilience.DISPOSITIONS


def _sigterm_script(res, trainer_fails):
    class Fleet:
        calls = 0

        def preempt_all(self):
            Fleet.calls += 1

    class Engine:
        calls = 0

        def drain(self):
            Engine.calls += 1

    class Trainer:
        saved = []

        def save_checkpoint(self, path, weights_only=False):
            if trainer_fails:
                raise OSError("disk gone")
            Trainer.saved.append((path, weights_only))

    original = signal.getsignal(signal.SIGTERM)
    try:
        handler = res.install_sigterm_drain(Fleet())
        installed = signal.getsignal(signal.SIGTERM) is handler
        handler(signal.SIGTERM, None)
        res.install_sigterm_drain(Engine(), trainer=Trainer(),
                                  checkpoint_path="w.ckpt")(signal.SIGTERM,
                                                            None)
    finally:
        signal.signal(signal.SIGTERM, original)
    return [installed, Fleet.calls, Engine.calls, Trainer.saved]


@pytest.mark.parametrize("trainer_fails", [False, True])
def test_sigterm_drain_matches_jax(trainer_fails):
    got = _sigterm_script(port_resilience, trainer_fails)
    assert got == _sigterm_script(jax_resilience, trainer_fails)
    assert got[:3] == [True, 1, 1]
    assert got[3] == ([] if trainer_fails else [("w.ckpt", True)])


# --------------------------------------------------------------------- #
# the engine under scripted faults, against the JAX engine
# --------------------------------------------------------------------- #
REQS = [([4, 8, 15], 6), ([16, 23, 42], 6), ([3, 1, 4, 1], 5),
        ([2, 7, 1], 5)]


def _crash_run(engine, mod):
    """Step by hand as the loop does: a ServeFault out of step() fails
    everything in flight; then two requests queue on the dead engine and
    are handed back."""
    comps = [engine.submit(p, max_new_tokens=n, request_id=f"r{i}")
             for i, (p, n) in enumerate(REQS)]
    steps = 0
    while True:
        try:
            engine.step()
            steps += 1
        except mod.ServeFault as e:
            engine._fail_all(e)
            break
    late = [engine.submit([9, 9, 2], max_new_tokens=3, request_id="late0",
                          priority=1),
            engine.submit([5, 5], max_new_tokens=2, request_id="late1")]
    back = engine.handback_queued()
    return (steps, [(c.finish_reason, type(c.error).__name__, list(c.tokens))
                    for c in comps + late],
            [{k: v for k, v in spec.items() if k != "deadline"}
             for spec in back], engine.alive, engine.pool.occupancy)


def test_crash_at_tick_and_handback_match_jax(model):
    jparams, jcfg, tparams, tcfg = model
    with fault_env("replica0:crash@tick3"):
        got = _crash_run(port_engine(tparams, tcfg, replica_index=0,
                                     num_slots=2), port_faults)
        want = _crash_run(jax_engine(jparams, jcfg, replica_index=0,
                                     num_slots=2), jax_faults)
    assert got == want
    steps, dispositions, back, alive, occupancy = got
    assert steps == 2 and not alive and occupancy == 0
    assert [d[:2] for d in dispositions[:4]] == [("error", "ServeFault")] * 4
    assert [d[0] for d in dispositions[4:]] == ["cancelled", "cancelled"]
    assert [b["request_id"] for b in back] == ["late0", "late1"]
    assert back[0]["prompt"] == [9, 9, 2] and back[0]["priority"] == 1


def test_crash_kills_the_loop_and_frees_the_engine(model):
    import gc
    import weakref

    _, _, tparams, tcfg = model
    with fault_env("replica0:crash@tick2"):
        engine = port_engine(tparams, tcfg, replica_index=0)
        comps = [engine.submit(p, max_new_tokens=n) for p, n in REQS]
        engine.start()
        deadline = time.time() + 60
        while engine.alive and time.time() < deadline:
            time.sleep(0.01)
    assert not engine.alive
    assert isinstance(engine.failed, port_faults.ServeFault)
    for c in comps:
        assert c.finish_reason == "error"
        with pytest.raises(port_faults.ServeFault):
            c.result(timeout=1)
    # dropped with its failed completions, the engine and its cache go
    cache = weakref.ref(engine.pool.cache["k"])
    del engine, comps, c
    gc.collect()
    assert cache() is None


def _journal_resume_run(engine, res, jparams, jcfg):
    """drop-stream on the 2nd admission: the journal resumes it on the same
    engine from prompt + delivered, under id ~r1."""
    journal = res.RequestJournal()
    streamed = {}
    entries = []
    for i, (prompt, n) in enumerate(REQS[:3]):
        entry = journal.open(prompt, n, request_id=f"q{i}",
                             on_token=lambda rid, t: streamed.setdefault(
                                 rid, []).append(t))
        rid, p, budget = journal.begin_attempt(entry, replica=0)
        comp = engine.submit(p, max_new_tokens=budget, request_id=rid,
                             on_token=journal.stream_guard(entry, rid))
        journal.bind(entry, comp)
        entries.append(entry)
    engine.run_until_idle()
    attempts = []
    for entry in entries:
        comp = entry.attempt_completion
        attempts.append((comp.finish_reason, list(comp.tokens)))
        if comp.finish_reason == "error":
            rid, p, budget = journal.begin_attempt(entry, replica=0)
            comp = engine.submit(p, max_new_tokens=budget, request_id=rid,
                                 on_token=journal.stream_guard(entry, rid))
            journal.bind(entry, comp)
            engine.run_until_idle()
            attempts.append((rid, p, budget, comp.finish_reason))
        journal.finish(entry, "completed", finish_reason="length")
    for entry, (prompt, n) in zip(entries, REQS):
        assert entry.result() == reference(jparams, jcfg, prompt, n)
    return attempts, streamed, journal.stats()


def test_drop_stream_journal_resume_matches_jax(model):
    jparams, jcfg, tparams, tcfg = model
    spec = "replica0:drop-stream@req2:4,replica0:slow-decode@every:4:0.001"
    with fault_env(spec):
        got = _journal_resume_run(port_engine(tparams, tcfg, replica_index=0),
                                  port_resilience, jparams, jcfg)
        want = _journal_resume_run(jax_engine(jparams, jcfg, replica_index=0),
                                   jax_resilience, jparams, jcfg)
    assert got == want
    attempts, streamed, stats = got
    assert attempts[1] == ("error", list(streamed["q1"][:4]))
    assert attempts[2] == ("q1~r1", tuple(REQS[1][0]) + tuple(
        streamed["q1"][:4]), 2, "length")
    assert stats["retries"] == 1 and stats["completed"] == 3
    # the client stream is each token once, in order
    assert streamed["q1"] == reference(jparams, jcfg, *REQS[1])


def _expiry_run(engine):
    comp = engine.submit([3, 1, 4, 1, 5], max_new_tokens=20,
                         request_id="late", deadline_ms=60_000.0)
    other = engine.submit([2, 7, 1, 8], max_new_tokens=6)
    for _ in range(4):
        engine.step()
    # the deadline runs out now, mid-decode, whatever the steps took
    slot = next(s for s in engine.pool.slots if s.request_id == "late")
    slot.deadline = time.perf_counter() - 1.0
    engine.run_until_idle()
    return (comp.finish_reason, list(comp.tokens), other.finish_reason,
            engine.pool.allocator.used_blocks, engine.pool.occupancy)


def test_deadline_expiry_mid_decode_matches_jax(model):
    jparams, jcfg, tparams, tcfg = model
    jeng = jax_engine(jparams, jcfg)
    jeng.submit([1, 2], max_new_tokens=2)  # compile outside the deadline
    jeng.run_until_idle()
    got = _expiry_run(port_engine(tparams, tcfg))
    want = _expiry_run(jeng)
    assert got == want
    reason, tokens, other, used, occupancy = got
    assert reason == "expired" and 0 < len(tokens) < 20
    assert tokens == reference(jparams, jcfg, [3, 1, 4, 1, 5], 20)[
        :len(tokens)]
    assert other == "length" and used == 0 and occupancy == 0


def test_slow_decode_stalls_its_ticks(model):
    _, _, tparams, tcfg = model
    engine = port_engine(tparams, tcfg, replica_index=1)
    engine.submit([1, 2, 3], max_new_tokens=8)
    with fault_env("replica1:slow-decode@every:2:0.05,replica0:crash@tick1"):
        times = []
        while engine.scheduler.has_work():
            t = time.perf_counter()
            engine.step()
            times.append(time.perf_counter() - t)
    stalled = times[1::2]
    assert min(stalled) >= 0.05 and engine.alive
    load = engine.load()
    assert load["ttft_p95_ms"] > 0 and load["itl_p99_ms"] >= 50.0
    assert load["role"] == "both" and load["queue_depth"] == 0
    desc = engine.describe()
    assert desc["tokens_out"] == 8 and desc["kv_layout"] == "paged"
    assert 0 < desc["slot_utilization"] <= 1 and desc["block_utilization"] == 0


_HANG_SCRIPT = """
import json, os, sys, time
import torch
from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_params
from ray_lightning_tpu_torch.serving import EngineConfig, InferenceEngine

os.environ["TORCHRT_FAULT"] = "replica3:hang@tick2"
cfg = LlamaConfig.tiny()
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
engine = InferenceEngine(params, cfg, EngineConfig(
    num_slots=2, max_prompt_len=8, max_len=32, block_size=4,
    kv_layout="paged"), device="cpu", replica_index=3)
comp = engine.submit([1, 2, 3], max_new_tokens=20)
engine.start()
deadline = time.time() + 60
while engine._ticks < 2 and time.time() < deadline:
    time.sleep(0.01)
time.sleep(0.3)
print(json.dumps({"ticks": engine._ticks, "done": comp.done,
                  "daemon": engine._thread.daemon,
                  "thread_alive": engine._thread.is_alive(),
                  "alive": engine.alive}), flush=True)
"""


def test_hang_blocks_the_loop_forever():
    """hang@tick blocks the loop thread (a daemon) where it stands: the
    engine stops ticking and never finishes the request, and ``alive``
    cannot tell (a hang is a supervisor's to detect). In a child process,
    so that the thread it blocks forever leaves this one."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items()
           if k not in (port_faults.FAULT_ENV, port_faults.FUSE_ENV)}
    out = subprocess.run([sys.executable, "-c", _HANG_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ticks": 2, "done": False, "daemon": True,
                   "thread_alive": True, "alive": True}
