"""The port's in-process fleet (ray_lightning_tpu_torch/serving/replica.py,
``LocalReplicaFleet``) on the CPU, held against the JAX package: routing,
the recovery pump under a sustained kill loop, the breaker's half-open
probe, zero drop under preemption and scale-down, the hand-back of a wedged
replica's backlog, deadlines, tenant quotas, the autoscaler and the SIGTERM
drain. Greedy streams equal JAX's ``generate`` on the same weights (fp32),
and the journal's dispositions equal JAX's fleet's on the deterministic
paths. Waits carry timeouts; no check leans on a sleep."""
import gc
import signal
import threading
import weakref

import pytest
import torch

from ray_lightning_tpu.serving import LocalReplicaFleet as JaxFleet
from ray_lightning_tpu.serving.tenancy import TenantRegistry as JaxRegistry
from ray_lightning_tpu.serving.tenancy import TenantSpec as JaxTenantSpec
from ray_lightning_tpu_torch import kernels
from ray_lightning_tpu_torch.serving import (
    Autoscaler,
    CapacityBlocked,
    CircuitBreaker,
    LocalReplicaFleet,
    QuotaExceeded,
    RequestQueueFull,
    TenantRegistry,
    TenantSpec,
    install_sigterm_drain,
)
from ray_lightning_tpu_torch.serving.resilience import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
)
from torch_fleet_helpers import wait_for
from torch_serving_helpers import (
    fault_env,
    random_requests,
    reference,
    references,
    tiny_models,
    two_threads,
)

pytestmark = pytest.mark.serving

ENGINE_KW = dict(num_slots=4, max_prompt_len=16, max_len=32, max_queue=64)
DISPOSITIONS = ("completed", "shed", "expired", "failed", "quota_rejected")
WAIT = 60.0


@pytest.fixture(scope="module")
def model():
    prev = two_threads()
    yield tiny_models()
    torch.set_num_threads(prev)


def _port_fleet(model, **kw):
    _, _, tparams, tcfg = model
    return LocalReplicaFleet(lambda: (tparams, tcfg), device="cpu",
                             **{"engine_kwargs": ENGINE_KW, **kw})


def _jax_fleet(model, **kw):
    jparams, jcfg, _, _ = model
    return JaxFleet(lambda: (jparams, jcfg),
                    **{"engine_kwargs": ENGINE_KW, **kw})


def _dispositions(fleet):
    stats = fleet.stats()
    return {d: stats[d] for d in DISPOSITIONS}


def test_fleet_routes_over_replicas_token_identical(model):
    jparams, jcfg, _, tcfg = model
    reqs = random_requests(tcfg.vocab_size, 8, 1)
    want = references(jparams, jcfg, reqs)
    fleet = _port_fleet(model, initial_replicas=2)
    try:
        assert fleet.num_replicas == 2 and fleet.device.type == "cpu"
        entries = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
        for w, e in zip(want, entries):
            assert e.result(timeout=WAIT) == w
            assert e.retries == 0 and e.disposition == "completed"
        routed = fleet.stats()["routed"]
        assert routed[0] >= 1 and routed[1] >= 1 and sum(routed.values()) == 8
        assert all(eng.load()["role"] == "both"
                   for eng in fleet._replicas.values())
    finally:
        fleet.shutdown()
    assert _dispositions(fleet)["completed"] == 8


def test_kill_loop_completes_every_request_token_identical(model):
    """``replica0:crash@every:6`` with no fuse: the relaunched engine dies
    again and again; every request completes with JAX ``generate``'s stream,
    delivered to the client once and in order, and the dead engines are
    freed (none is kept alive by the fleet after its shutdown)."""
    jparams, jcfg, _, tcfg = model
    reqs = random_requests(tcfg.vocab_size, 12, 23, lo=5, hi=9)
    wants = references(jparams, jcfg, reqs)
    refs = []
    with fault_env("replica0:crash@every:6"):
        fleet = _port_fleet(model, initial_replicas=2, max_retries=6,
                            breaker_threshold=2, breaker_cooldown_s=0.3)
        refs.append(weakref.ref(fleet._replicas[0]))
        try:
            streams = {i: [] for i in range(len(reqs))}
            entries = [fleet.submit(
                p, max_new_tokens=n,
                on_token=lambda _rid, t, i=i: streams[i].append(t))
                for i, (p, n) in enumerate(reqs)]
            for i, (want, e) in enumerate(zip(wants, entries)):
                assert e.result(timeout=WAIT) == want
                assert streams[i] == want
            stats = fleet.stats()
            assert stats["completed"] == len(reqs)
            assert stats["failed"] == 0 and stats["shed"] == 0
            assert fleet.relaunches_total >= 1 and stats["retries"] >= 1
            assert stats["relaunches"] == fleet.relaunches_total
            assert (BREAKER_CLOSED, BREAKER_OPEN) in [
                (a, b) for _, a, b in fleet.breakers[0].transitions]
        finally:
            fleet.shutdown()
    del entries, e
    gc.collect()
    assert all(r() is None for r in refs), "a crashed engine is still alive"


def test_open_breaker_routes_zero_until_the_probe_succeeds(model):
    """While replica 0's breaker is open it receives no request; after its
    cooldown (a scripted clock) the next request is the half-open probe,
    whose success closes it."""
    jparams, jcfg, _, _ = model
    now = [0.0]
    fleet = _port_fleet(model, initial_replicas=2, breaker_threshold=2)
    try:
        b0 = CircuitBreaker(failure_threshold=2, open_cooldown_s=0.5,
                            clock=lambda: now[0])
        fleet.breakers[0] = b0
        b0.record_failure()
        b0.record_failure()
        assert b0.state == BREAKER_OPEN
        routed_before = fleet.routed_total[0]
        prompts = [[7, i + 1, 3] for i in range(6)] + [[9, 9, 2]]
        want = references(jparams, jcfg, [(p, 5) for p in prompts])
        entries = [fleet.submit(p, max_new_tokens=5) for p in prompts[:6]]
        for w, e in zip(want, entries):
            assert e.result(timeout=WAIT) == w
        assert fleet.routed_total[0] == routed_before
        assert all(e.replica_history == [1] for e in entries)
        now[0] = 0.6  # the cooldown has passed: this request is the probe
        probe = fleet.submit([9, 9, 2], max_new_tokens=5)
        assert probe.result(timeout=WAIT) == want[6]
        assert probe.replica_history == [0]
        assert fleet.routed_total[0] == routed_before + 1
        fleet.pump_once()  # settles the probe's outcome
        assert b0.state == BREAKER_CLOSED
        assert [(a, b) for _, a, b in b0.transitions] == [
            (BREAKER_CLOSED, BREAKER_OPEN),
            (BREAKER_OPEN, BREAKER_HALF_OPEN),
            (BREAKER_HALF_OPEN, BREAKER_CLOSED),
        ]
    finally:
        fleet.shutdown()


def test_drop_stream_resumes_bitwise(model):
    jparams, jcfg, _, _ = model
    with fault_env("replica0:drop-stream@req1:2"):
        fleet = _port_fleet(model, initial_replicas=1, max_retries=3)
        try:
            streamed = []
            prompt, n_new = [4, 8, 15], 8
            entry = fleet.submit(prompt, max_new_tokens=n_new,
                                 on_token=lambda rid, t: streamed.append(t))
            want = reference(jparams, jcfg, prompt, n_new)
            assert entry.result(timeout=WAIT) == want and streamed == want
            assert entry.retries == 1 and entry.replica_history == [0, 0]
            assert entry.attempt_rids == [entry.request_id,
                                          f"{entry.request_id}~r1"]
            assert fleet.stats()["failed"] == 0
        finally:
            fleet.shutdown()


def test_preempt_replica_migrates_backlog_zero_drop_like_jax(model):
    jparams, jcfg, _, tcfg = model
    reqs = random_requests(tcfg.vocab_size, 10, 11, lo=4, hi=7, plen=4)
    want = references(jparams, jcfg, reqs)
    got = {}
    for name, make in (("port", _port_fleet), ("jax", _jax_fleet)):
        fleet = make(model, engine_kwargs=dict(ENGINE_KW, num_slots=2),
                     initial_replicas=2)
        try:
            entries = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
            assert fleet.preempt_replica(0)
            assert not fleet.preempt_replica(0)  # already gone
            assert fleet.num_replicas == 1
            for w, e in zip(want, entries):
                assert e.result(timeout=WAIT) == w
            got[name] = _dispositions(fleet)
        finally:
            fleet.shutdown()
    assert got["port"] == got["jax"] == dict(
        completed=10, shed=0, expired=0, failed=0, quota_rejected=0)


_WEDGED_SCRIPT = r"""
import json, sys, time
sys.path.insert(0, sys.argv[2])
from torch_fleet_helpers import saved_builder
from ray_lightning_tpu_torch.serving import LocalReplicaFleet

params, cfg = saved_builder(sys.argv[1])
fleet = LocalReplicaFleet(
    lambda: (params, cfg), device="cpu", initial_replicas=2, max_retries=3,
    drain_timeout=1.0, engine_kwargs=dict(num_slots=1, max_prompt_len=16,
                                          max_len=32, max_queue=64))
entries = [fleet.submit([6, i + 1], max_new_tokens=4) for i in range(6)]
wedged = fleet._replicas[0]
deadline = time.monotonic() + 60
while wedged._ticks < 1:  # wedged at its first tick
    assert time.monotonic() < deadline
    time.sleep(0.005)
removed = [fleet.remove_replica(0), fleet.remove_replica(0)]
streams = [e.result(timeout=60) for e in entries]
fleet.shutdown()
stats = fleet.stats()
print(json.dumps({"removed": removed, "streams": streams,
                  "stats": {k: stats[k] for k in (
                      "completed", "shed", "expired", "failed",
                      "quota_rejected")}}))
"""


@pytest.mark.parametrize("package", ["port", "jax"])
def test_scale_down_drain_timeout_hands_back_the_queue_like_jax(
        model, package, tmp_path):
    """remove_replica on a wedged engine (``replica0:hang@tick1``): after the
    drain timeout its queued backlog is handed back and migrates, and every
    request completes on the other replica, in both packages with the same
    dispositions. The port's fleet runs in a child process, which its hung
    loop thread (a daemon, blocked for good) leaves with it."""
    import json
    import os
    import subprocess
    import sys

    from torch_fleet_helpers import save_model

    jparams, jcfg, tparams, tcfg = model
    prompts = [[6, i + 1] for i in range(6)]
    want = references(jparams, jcfg, [(p, 4) for p in prompts])
    with fault_env("replica0:hang@tick1"):
        if package == "port":
            path = str(tmp_path / "tiny.pt")
            save_model(path, tparams, tcfg)
            here = os.path.dirname(os.path.abspath(__file__))
            out = subprocess.run(
                [sys.executable, "-c", _WEDGED_SCRIPT, path, here],
                cwd=os.path.dirname(here), capture_output=True, text=True,
                timeout=180)
            assert out.returncode == 0, out.stderr[-2000:]
            got = json.loads(out.stdout.strip().splitlines()[-1])
            assert got["removed"] == [0, None]  # then the one-replica floor
            assert got["streams"] == want
            disp = got["stats"]
        else:
            fleet = _jax_fleet(model, engine_kwargs=dict(ENGINE_KW,
                                                         num_slots=1),
                               initial_replicas=2, max_retries=3,
                               drain_timeout=1.0)
            try:
                entries = [fleet.submit(p, max_new_tokens=4)
                           for p in prompts]
                wedged = fleet._replicas[0]
                wait_for(lambda: wedged._ticks >= 1)
                assert fleet.remove_replica(0) == 0
                assert fleet.remove_replica(0) is None
                for w, e in zip(want, entries):
                    assert e.result(timeout=WAIT) == w
            finally:
                fleet.shutdown()
            disp = _dispositions(fleet)
    assert disp == dict(completed=6, shed=0, expired=0, failed=0,
                        quota_rejected=0)


def test_dead_on_arrival_deadline_expires_like_jax(model):
    got = {}
    for name, make in (("port", _port_fleet), ("jax", _jax_fleet)):
        fleet = make(model, initial_replicas=1)
        try:
            entry = fleet.submit([1, 2, 3], max_new_tokens=4, deadline_ms=0.0)
            assert entry.done and entry.disposition == "expired"
            assert entry.finish_reason == "expired" and entry.result() == []
            got[name] = _dispositions(fleet)
        finally:
            fleet.shutdown()
    assert got["port"] == got["jax"] and got["port"]["expired"] == 1


def test_quota_rejection_is_not_a_shed_like_jax(model):
    got = {}
    for name, make, reg_cls, spec_cls in (
            ("port", _port_fleet, TenantRegistry, TenantSpec),
            ("jax", _jax_fleet, JaxRegistry, JaxTenantSpec)):
        clock = [0.0]
        registry = reg_cls([
            spec_cls("gold", tenant_class="guaranteed", weight=4.0),
            spec_cls("metered", rate=0.0, burst=2.0),
        ], clock=lambda: clock[0])
        fleet = make(model, initial_replicas=1, tenants=registry)
        try:
            done = [fleet.submit([1, 2], max_new_tokens=3, tenant="metered")
                    for _ in range(2)]
            with pytest.raises(Exception) as exc:
                fleet.submit([1, 2], max_new_tokens=3, tenant="metered")
            assert type(exc.value).__name__ == "QuotaExceeded"
            if name == "port":
                # a back-pressure error, never a shed
                assert isinstance(exc.value, (QuotaExceeded, RequestQueueFull))
                # charged once, at the fleet: its engines do not admit
                assert all(not e._tenancy_admission
                           for e in fleet._replicas.values())
            for entry in done:
                assert entry.result(timeout=WAIT)
                assert entry.disposition == "completed"
                assert entry.tenant == "metered"
            assert fleet.submit([3, 1], max_new_tokens=3,
                                tenant="gold").result(timeout=WAIT)
            assert fleet.submit([3, 1], max_new_tokens=3).result(timeout=WAIT)
            got[name] = (_dispositions(fleet), dict(registry.admitted))
        finally:
            fleet.shutdown()
    assert got["port"] == got["jax"]
    disp, admitted = got["port"]
    assert disp["quota_rejected"] == 1 and disp["shed"] == 0
    assert disp["completed"] == 4 and admitted["metered"] == 2


def test_autoscaler_scales_up_and_drains_down(model):
    """A burst on one replica trips the scaler (ticked here); every request
    completes with JAX ``generate``'s stream, including those of replicas
    drained later; idle ticks drain the fleet back to one."""
    jparams, jcfg, _, tcfg = model
    fleet = _port_fleet(model, engine_kwargs=dict(num_slots=2,
                                                  max_prompt_len=8,
                                                  max_len=32),
                        initial_replicas=1)
    scaler = Autoscaler(fleet, min_replicas=1, max_replicas=3,
                        queue_high=2.0, idle_ticks_down=2)
    try:
        reqs = random_requests(tcfg.vocab_size, 12, 7, lo=4, hi=7)
        want = references(jparams, jcfg, reqs)
        comps = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
        # up to 10 queued behind 2 slots: the first tick scales up
        assert scaler.tick() == 1
        assert fleet.num_replicas == 2 and scaler.last_outcome == "scale_up"
        for w, c in zip(want, comps):
            assert c.result(timeout=WAIT) == w
        stats = fleet.stats()
        assert stats["completed"] == 12 and stats["failed"] == 0
        assert stats["shed"] == 0 and stats["expired"] == 0
        # the fleet is idle: the first idle verdict arms, the second drains
        wait_for(lambda: all(e.load()["active"] == 0
                          for e in fleet._replicas.values()))
        assert scaler.tick() == 0
        assert scaler.tick() == -1 and fleet.num_replicas == 1
        assert scaler.tick() == 0  # the floor
        assert scaler.scale_ups == 1 and scaler.scale_downs == 1
        assert [h[1:] for h in scaler.history] == [(2, 1), (1, -1)]
        assert fleet.removed_total == fleet.added_total - 1
    finally:
        fleet.shutdown()


def test_capacity_blocks_scale_up_not_relaunch(model):
    fleet = _port_fleet(model, initial_replicas=1, capacity=1)
    scaler = Autoscaler(fleet, min_replicas=1, max_replicas=3, queue_high=0.5)
    try:
        with pytest.raises(CapacityBlocked, match="capacity"):
            fleet.add_replica()
        # a dead replica's relaunch under its index is never refused
        fleet._replicas[0].shutdown(drain=False)
        wait_for(lambda: fleet.relaunches_total == 1 and fleet.num_replicas == 1)
        assert list(fleet._replicas) == [0]
        fleet.grant_capacity(1)
        assert fleet.capacity == 2
        assert fleet.add_replica() == 1 and fleet.num_replicas == 2
        fleet.revoke_capacity(5)
        assert fleet.capacity == 1
        fake = {0: {"queue_depth": 9}}
        fleet.loads = lambda: fake
        assert scaler.tick(now=0.0) == 0
        assert scaler.last_outcome == "capacity_blocked"
        assert scaler.capacity_blocked_streak == 1
    finally:
        fleet.shutdown()
    with pytest.raises(ValueError, match="capacity"):
        _port_fleet(model, capacity=0)


def test_disaggregated_split_validates_like_jax(model):
    for kw in (dict(initial_replicas=2, prefill_replicas=-1),
               dict(initial_replicas=2, prefill_replicas=2),
               dict(initial_replicas=3, prefill_replicas=1)):
        errors = []
        for make in (_port_fleet, _jax_fleet):
            with pytest.raises(ValueError) as exc:
                make(model, **kw)
            errors.append(str(exc.value))
        assert errors[0] == errors[1]


def test_sigterm_drain_with_a_real_fleet(model):
    """``install_sigterm_drain(fleet)``: the handler drains the fleet
    (``preempt_all``), every request in flight finishes, and the fleet is
    shut down."""
    jparams, jcfg, _, tcfg = model
    reqs = random_requests(tcfg.vocab_size, 6, 4)
    want = references(jparams, jcfg, reqs)
    fleet = _port_fleet(model, initial_replicas=2)
    original = signal.getsignal(signal.SIGTERM)
    try:
        handler = install_sigterm_drain(fleet)
        assert signal.getsignal(signal.SIGTERM) is handler
        entries = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
        handler(signal.SIGTERM, None)
        for w, e in zip(want, entries):
            assert e.done and e.result() == w
        assert fleet.num_replicas == 0
        assert not fleet._pump_thread.is_alive()
        assert _dispositions(fleet)["completed"] == 6
    finally:
        signal.signal(signal.SIGTERM, original)
        fleet.shutdown()


def test_warmup_and_request_records_on_the_cpu(model):
    """On the CPU ``warmup`` loads nothing and launches nothing; with
    telemetry off the request records are empty, as the JAX engine's."""
    fleet = _port_fleet(model, initial_replicas=1)
    try:
        engine = fleet._replicas[0]
        before = (dict(engine.stats), kernels.launch_counts())
        assert engine.warmup() == []
        assert (dict(engine.stats), kernels.launch_counts()) == before
        assert not kernels._LIBS
        fleet.submit([1, 2, 3], max_new_tokens=3).result(timeout=WAIT)
        assert engine.drain_request_records() == []
        assert fleet.drain_request_records() == []
    finally:
        fleet.shutdown()


def test_shutdown_fails_what_is_still_in_flight(model):
    """A request whose replica is gone and that nothing can take ends
    ``"failed"`` at shutdown; the pump thread has stopped."""
    fleet = _port_fleet(model, initial_replicas=1, relaunch=False)
    try:
        fleet._replicas[0].shutdown(drain=False)
        fleet.pump_once()  # discards the dead engine, no relaunch
        assert fleet.num_replicas == 0 and fleet.relaunches_total == 1
        entry = fleet.submit([1, 2], max_new_tokens=2)  # parked
        assert not entry.done
    finally:
        fleet.shutdown()
    assert entry.disposition == "failed" and entry.finish_reason == "error"
    assert "shut down" in str(entry.error)
    assert not fleet._pump_thread.is_alive()


def test_aggregator_receives_replica_deaths(model):
    events = []
    sources = {}

    class _Agg:
        def record_event(self, kind, **fields):
            events.append((kind, fields))

        def register_incident_source(self, name, fn):
            sources[name] = fn

    with fault_env("replica0:crash@tick2"):
        fleet = _port_fleet(model, initial_replicas=1, max_retries=3)
        fleet.attach_aggregator(_Agg())
        try:
            # each engine decodes one token at its first tick, dies at its
            # second: the retry finishes the request on the relaunch
            entry = fleet.submit([5, 6, 7], max_new_tokens=2)
            assert len(entry.result(timeout=WAIT)) == 2
            assert fleet.relaunches_total >= 1
        finally:
            fleet.shutdown()
    assert sources["request_journal"]() == fleet.stats()
    kinds = [k for k, _ in events]
    assert kinds == ["serve_replica_dead"] * fleet.relaunches_total
    assert events[0][1]["replica"] == 0 and "ServeFault" in \
        events[0][1]["error"]


def test_concurrent_submitters_lose_no_request(model):
    """Six threads submit at once with a short switch interval: every
    request lands in the journal and completes exactly once."""
    import sys

    fleet = _port_fleet(model, initial_replicas=2)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    out, errors = [], []

    def submit(k):
        try:
            for i in range(4):
                out.append(fleet.submit([k + 1, i + 1], max_new_tokens=2))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(prev)
    try:
        assert not errors
        for e in out:
            e.result(timeout=WAIT)
        stats = fleet.stats()
        assert stats["completed"] == 24 and stats["open"] == 0
        assert sum(stats["routed"].values()) == 24
        assert len({e.request_id for e in out}) == 24
    finally:
        fleet.shutdown()


def test_builder_runs_once_and_params_must_live_on_the_device(model):
    _, _, tparams, tcfg = model
    calls = []

    def builder():
        calls.append(1)
        return tparams, tcfg

    fleet = LocalReplicaFleet(builder, engine_kwargs=ENGINE_KW,
                              initial_replicas=2, device="cpu")
    try:
        fleet.add_replica()
        assert len(calls) == 1 and fleet.num_replicas == 3
        engines = list(fleet._replicas.values())
        assert all(e.params is tparams for e in engines)
    finally:
        fleet.shutdown()
    elsewhere = dict(tparams, embed=tparams["embed"].to("meta"))
    with pytest.raises(ValueError, match="params live on"):
        LocalReplicaFleet(lambda: (elsewhere, tcfg), engine_kwargs=ENGINE_KW,
                          device="cpu")
