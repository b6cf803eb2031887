"""The port's replica group (ray_lightning_tpu_torch/serving/replica.py:
``ReplicaGroup`` over ``ServeReplicaActor`` processes, the heartbeat queue
and the monitor-mode Supervisor with its load tap) on the CPU, two actors
of the tiny fp32 model whose weights the builder reads from a file: the
streams equal JAX's ``generate`` on the same weights; a SIGKILLed actor is
relaunched by ``check()`` and its requests resume; a replica added then
removed drops nothing; ``telemetry=True`` is refused."""
import functools
import os
import signal

import pytest
import torch

from ray_lightning_tpu_torch import runtime as rt
from ray_lightning_tpu_torch.runtime.api import pid_exited
from ray_lightning_tpu_torch.serving import ReplicaGroup, ServeReplicaActor
from torch_fleet_helpers import save_model, saved_builder, wait_for
from torch_serving_helpers import references, tiny_models, two_threads

pytestmark = pytest.mark.serving

ENGINE_KW = dict(num_slots=2, max_prompt_len=16, max_len=48, max_queue=64)
WAIT = 60.0


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    prev = two_threads()
    jparams, jcfg, tparams, tcfg = tiny_models()
    path = str(tmp_path_factory.mktemp("replica_group") / "tiny.pt")
    save_model(path, tparams, tcfg)
    yield jparams, jcfg, functools.partial(saved_builder, path), tcfg
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _runtime():
    yield
    rt.shutdown()


def _group(builder, n=2, **kw):
    return ReplicaGroup(builder, engine_kwargs=ENGINE_KW, num_replicas=n,
                        device="cpu", heartbeat_interval=0.1,
                        actor_timeout=WAIT, **kw).start()


def test_group_serves_balances_and_beats(model):
    jparams, jcfg, builder, tcfg = model
    reqs = [([3 + i, 1, 4, 1 + i], 5 + i % 3) for i in range(6)]
    want = references(jparams, jcfg, reqs)
    group = _group(builder)
    try:
        assert group.num_replicas == 2
        futures = [group.submit(p, max_new_tokens=n) for p, n in reqs]
        assert [f.result(timeout=WAIT) for f in futures] == want
        assert {f.replica for f in futures} == {0, 1}
        assert [f.request_id for f in futures] == [f"g{i}" for i in range(6)]
        assert group.check() == {0: "ok", 1: "ok"}
        # the beats reach the tap through the supervisor: each replica's
        # report, once a beat follows the last request, is idle
        wait_for(lambda: set(group.loads()) == {0, 1} and all(
            load.get("role") == "both" and load["queue_depth"] == 0
            and load["active"] == 0 for load in group.loads().values()))
        routed = group.routed_total
        assert set(routed) == {0, 1} and sum(routed.values()) == 6
        assert group.retries_total == 0
    finally:
        group.shutdown()
    assert group.handles == {}


def test_killed_actor_is_relaunched_and_its_requests_resume(model):
    """SIGKILL replica 0 while it decodes (its ticks slowed by a scripted
    stall): ``check()`` relaunches it under its index, each of its requests
    resumes (``~r1``) with the tokens it had, and every stream equals
    ``generate``'s; one breaker failure is charged."""
    jparams, jcfg, builder, _ = model
    reqs = [([5 + i, 9, 2, 6], 24) for i in range(4)]
    want = references(jparams, jcfg, reqs)
    group = _group(builder, env={
        "TORCHRT_FAULT": "replica0:slow-decode@every:1:0.05"})
    try:
        futures = [group.submit(p, max_new_tokens=n) for p, n in reqs]
        on_zero = [f for f in futures if f.replica == 0]
        assert on_zero
        wait_for(lambda: len(
            group._poll(0, on_zero[0].request_id)["tokens"]) >= 2)
        pid = group.handles[0]._pid
        os.kill(pid, signal.SIGKILL)
        wait_for(lambda: pid_exited(pid))
        assert group.check() == {0: "relaunched", 1: "ok"}
        assert group.relaunches_total == 1
        assert group.handles[0]._pid != pid
        assert [f.result(timeout=WAIT) for f in futures] == want
        assert group.retries_total >= len(on_zero)
        assert group.breakers[0].failures_total >= 1
        kinds = [k for k, _ in group.tap.events]
        assert "serve_replica_relaunch" in kinds
    finally:
        group.shutdown()


def test_add_and_remove_a_replica_with_zero_dropped(model):
    jparams, jcfg, builder, _ = model
    reqs = [([2 + i, 7, 1], 6) for i in range(6)]
    want = references(jparams, jcfg, reqs)
    group = _group(builder, n=1)
    try:
        assert group.add_replica() == 1 and group.num_replicas == 2
        futures = [group.submit(p, max_new_tokens=n) for p, n in reqs]
        assert {f.replica for f in futures} == {0, 1}
        assert group.remove_replica() == 1
        assert group.num_replicas == 1
        assert group.remove_replica() is None  # the floor
        assert [f.result(timeout=WAIT) for f in futures] == want
        for t in group._drain_threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        assert list(group.handles) == [0]
        assert group.added_total == 1 and group.removed_total == 1
        # new requests go to the survivor
        more = group.submit([4, 4, 4], max_new_tokens=3)
        assert more.replica == 0
        assert more.result(timeout=WAIT) == references(
            jparams, jcfg, [([4, 4, 4], 3)])[0]
    finally:
        group.shutdown()


def test_telemetry_and_unpicklable_builders_are_refused(model):
    _, _, builder, _ = model
    with pytest.raises(NotImplementedError, match="item 9"):
        ReplicaGroup(builder, telemetry=True)
    with pytest.raises(NotImplementedError, match="item 9"):
        ServeReplicaActor(builder, telemetry=True)
    group = ReplicaGroup(lambda: None, engine_kwargs=ENGINE_KW,
                         num_replicas=1, device="cpu")
    with pytest.raises(TypeError, match="module level"):
        group.start()
    assert group.handles == {} and group._queue is None
    with pytest.raises(RuntimeError, match="start"):
        group.submit([1, 2], max_new_tokens=2)
    with pytest.raises(ValueError):
        ReplicaGroup(builder, num_replicas=0)
