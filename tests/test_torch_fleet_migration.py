"""The port's disaggregated fleet (ray_lightning_tpu_torch/serving/
replica.py: the prefill and decode pools, the migration pump's send ->
verify -> admit ladder, its retries, backoff and colocated fallback) on the
CPU, held against the JAX package: streams token-identical to JAX's
``generate`` (fp32), the warm-chain affinity key bitwise JAX's, and under
the same fault script the same ``MigrationStats`` as JAX's fleet."""
import types

import pytest
import torch

from ray_lightning_tpu.serving import LocalReplicaFleet as JaxFleet
from ray_lightning_tpu.serving import MigrationPolicy as JaxPolicy
from ray_lightning_tpu_torch.serving import (
    EngineConfig,
    InferenceEngine,
    LocalReplicaFleet,
    MigrationPolicy,
)
from torch_fleet_helpers import wait_for
from torch_serving_helpers import (
    PAGED_KW,
    fault_env,
    random_requests,
    references,
    tiny_models,
    two_threads,
)

pytestmark = pytest.mark.serving

WAIT = 60.0


@pytest.fixture(scope="module")
def model():
    prev = two_threads()
    yield tiny_models()
    torch.set_num_threads(prev)


def _fleet(model, package="port", replicas=2, prefill=1, policy=None, **kw):
    """A disaggregated fleet of either package. The send and admit timeouts
    are generous (the JAX engine compiles its export and its import at the
    first one), so that only the scripted faults fail an attempt."""
    jparams, jcfg, tparams, tcfg = model
    kw = dict(dict(engine_kwargs=PAGED_KW, max_retries=4), **kw,
              initial_replicas=replicas, prefill_replicas=prefill)
    policy = dict({"send_timeout_s": WAIT, "admit_timeout_s": WAIT},
                  **(policy or {}))
    if package == "port":
        return LocalReplicaFleet(lambda: (tparams, tcfg), device="cpu",
                                 migration_policy=MigrationPolicy(**policy),
                                 **kw)
    return JaxFleet(lambda: (jparams, jcfg),
                    migration_policy=JaxPolicy(**policy), **kw)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_disaggregated_fleet_token_identical_like_jax(model, package):
    """Each package's fleet of a prefill and a decode replica serves 6
    requests with JAX ``generate``'s streams and the same stats: every
    request prefilled on the prefill pool, shipped once (its 2 prompt
    blocks), decoded on the decode pool, and no retry charged."""
    jparams, jcfg, _, tcfg = model
    reqs = random_requests(tcfg.vocab_size, 6, 5)
    want = references(jparams, jcfg, reqs)
    fleet = _fleet(model, package)
    try:
        assert fleet.stats()["roles"] == {0: "prefill", 1: "decode"}
        entries = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
        for w, e in zip(want, entries):
            assert e.result(timeout=WAIT) == w
            assert e.replica_history[:2] == [0, 1] and e.retries == 0
        stats = fleet.stats()
    finally:
        fleet.shutdown()
    block = 2 * tcfg.n_layers * tcfg.n_kv_heads * PAGED_KW["block_size"] * \
        tcfg.head_dim * 4  # k and v, fp32
    assert stats["migration"] == dict(
        attempts=6, verified=6, corrupt=0, retries=0, fallbacks=0,
        migrated=6, bytes_shipped=6 * 2 * block)
    assert stats["completed"] == 6 and stats["retries"] == 0
    assert stats["routed"] == {0: 6, 1: 6}


@pytest.mark.parametrize("prompt", [
    [9, 9, 9, 9, 2, 4], [1], [3, 1, 4], list(range(40)), [2 ** 40, 7, 0, 5],
], ids=["long", "one", "short", "many", "wide"])
def test_affinity_key_bitwise_jax(prompt):
    for bs in (4, 16):
        fleet = types.SimpleNamespace(_affinity_bs=bs)
        assert LocalReplicaFleet._affinity_key(fleet, prompt) == \
            JaxFleet._affinity_key(fleet, prompt)
        assert LocalReplicaFleet._affinity_key(fleet, tuple(prompt)) == \
            JaxFleet._affinity_key(fleet, prompt)


def test_warm_chain_affinity_routes_a_repeated_prefix_back(model):
    jparams, jcfg, _, _ = model
    prompt = [9, 9, 9, 9, 2, 4]  # its first block (4 tokens) is the key
    again = prompt[:4] + [7, 7]
    want = references(jparams, jcfg, [(prompt, 4), (again, 4)])
    fleet = _fleet(model, replicas=4, prefill=2)
    try:
        first = fleet.submit(prompt, max_new_tokens=4)
        assert first.result(timeout=WAIT) == want[0]
        warm = first.replica_history[0]
        assert warm in (0, 1)
        second = fleet.submit(again, max_new_tokens=4)
        assert second.result(timeout=WAIT) == want[1]
        assert second.replica_history[0] == warm
        assert fleet._affinity[fleet._affinity_key(again)] == warm
    finally:
        fleet.shutdown()


FAULT_CASES = {
    "corrupt": ("replica0:corrupt-shipment@req1", None,
                dict(corrupt=1, retries=1, migrated=1, verified=1,
                     attempts=2, fallbacks=0)),
    "drop": ("replica0:drop-shipment@req1", None,
             dict(corrupt=0, retries=1, migrated=1, verified=1, attempts=2,
                  fallbacks=0)),
    "stall": ("replica0:stall-shipment@req1:0.3",
              dict(send_timeout_s=0.1),
              dict(corrupt=0, retries=1, migrated=1, verified=1, attempts=2,
                   fallbacks=0)),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_shipment_fault_retries_like_jax(model, case):
    """A corrupt delivery is caught by the receiver's checksums (never
    decoded) and the clean original is resent; a dropped one, and one
    whose stalled send passes the policy's send timeout, are resent too.
    No retry is charged to the request; the stats equal JAX's fleet's."""
    jparams, jcfg, _, _ = model
    spec, policy, expect = FAULT_CASES[case]
    prompt, n_new = [3, 1, 4, 1], 6
    want = references(jparams, jcfg, [(prompt, n_new)])[0]
    got = {}
    for package in ("port", "jax"):
        with fault_env(spec):
            fleet = _fleet(model, package, policy=policy)
            try:
                e = fleet.submit(prompt, max_new_tokens=n_new)
                assert e.result(timeout=WAIT) == want
                assert e.retries == 0
                got[package] = fleet.stats()["migration"]
            finally:
                fleet.shutdown()
    assert got["port"] == got["jax"]
    assert {k: got["port"][k] for k in expect} == expect


def test_crash_mid_admit_falls_back_to_colocated_decode_like_jax(model):
    """Every import into the only decode replica crashes it mid-admit:
    after ``max_attempts`` the request un-parks and decodes on the prefill
    replica, counted, token-identical, never dropped."""
    jparams, jcfg, _, _ = model
    prompt, n_new = [5, 9, 2, 6], 6
    want = references(jparams, jcfg, [(prompt, n_new)])[0]
    got = {}
    for package in ("port", "jax"):
        with fault_env("replica1:crash-mid-admit@every:1"):
            fleet = _fleet(model, package, max_retries=6, breaker_threshold=2,
                           breaker_cooldown_s=0.2)
            try:
                e = fleet.submit(prompt, max_new_tokens=n_new)
                assert e.result(timeout=WAIT) == want
                stats = fleet.stats()
                assert stats["failed"] == 0 and e.retries == 0
                got[package] = stats["migration"]
            finally:
                fleet.shutdown()
    assert got["port"] == got["jax"]
    m = got["port"]
    assert m["fallbacks"] == 1 and m["migrated"] == 0 and m["verified"] == 0
    assert m["attempts"] == 3 and m["retries"] == 2


def test_decode_replica_killed_mid_migration(model, tmp_path, monkeypatch):
    """The decode replica crashes a few steps after the shipment landed
    (fused: once): the journal resumes prompt + delivered through the
    prefill pool, token-identical, with one charged retry."""
    jparams, jcfg, _, _ = model
    prompt, n_new = [4, 8, 15, 16], 8
    want = references(jparams, jcfg, [(prompt, n_new)])[0]
    with fault_env("replica1:crash@tick4"):
        monkeypatch.setenv("TORCHRT_FAULT_FUSE", str(tmp_path))
        fleet = _fleet(model, max_retries=4, breaker_threshold=3)
        try:
            streamed = []
            entry = fleet.submit(prompt, max_new_tokens=n_new,
                                 on_token=lambda rid, t: streamed.append(t))
            assert entry.result(timeout=WAIT) == want and streamed == want
            assert entry.retries == 1
            assert entry.replica_history[:2] == [0, 1]
            stats = fleet.stats()
            assert stats["completed"] == 1 and stats["failed"] == 0
            assert stats["migration"]["migrated"] >= 1
            assert fleet.relaunches_total == 1
        finally:
            fleet.shutdown()


def test_fallback_decode_beside_parked_slots_token_identical(model):
    """A 2-slot decode pool cannot hold the burst: some requests migrate,
    some fall back to decoding on the prefill replica beside slots still
    parked there; every stream equals ``generate``'s."""
    jparams, jcfg, _, tcfg = model
    reqs = random_requests(tcfg.vocab_size, 8, 7, lo=16, hi=17, plen=6)
    want = references(jparams, jcfg, reqs)
    fleet = _fleet(model, engine_kwargs=dict(PAGED_KW, num_slots=2),
                   policy=dict(max_attempts=2, backoff_base_s=0.01,
                               backoff_max_s=0.05))
    try:
        entries = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
        for w, e in zip(want, entries):
            assert e.result(timeout=WAIT) == w
        stats = fleet.stats()
        assert stats["completed"] == 8 and stats["failed"] == 0
        m = stats["migration"]
        assert m["corrupt"] == 0
        assert m["migrated"] >= 1 and m["fallbacks"] >= 1
        assert m["migrated"] + m["fallbacks"] == 8
    finally:
        fleet.shutdown()


def test_sustained_migration_kill_loop_zero_drop(model):
    """Dropped, corrupt and crash-mid-admit shipments, sustained across
    relaunches (no fuse): every request completes with ``generate``'s
    stream; every corrupt delivery is caught by the checksums."""
    jparams, jcfg, _, tcfg = model
    reqs = random_requests(tcfg.vocab_size, 10, 23)
    want = references(jparams, jcfg, reqs)
    spec = ("replica0:drop-shipment@every:5,replica0:corrupt-shipment@every:3,"
            "replica1:crash-mid-admit@every:4")
    with fault_env(spec):
        fleet = _fleet(model, replicas=3, prefill=1, max_retries=8,
                       breaker_threshold=3, breaker_cooldown_s=0.3)
        try:
            entries = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
            for w, e in zip(want, entries):
                assert e.result(timeout=WAIT) == w
            stats = fleet.stats()
            assert stats["completed"] == len(reqs)
            assert stats["failed"] == 0 and stats["shed"] == 0
            m = stats["migration"]
            assert m["corrupt"] >= 1 and m["retries"] >= 2
            assert m["migrated"] + m["fallbacks"] >= 1
        finally:
            fleet.shutdown()


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_single_pool_equals_colocated_serving(model, layout):
    """A homogeneous one-replica fleet serves exactly what a lone engine
    serves: the same streams (JAX ``generate``'s), role ``"both"``, no
    migration stats, on both layouts."""
    jparams, jcfg, tparams, tcfg = model
    ekw = dict(num_slots=4, max_prompt_len=16, max_len=32, max_queue=64,
               kv_layout=layout)
    if layout == "paged":
        ekw["block_size"] = 4
    reqs = random_requests(tcfg.vocab_size, 4, 3)
    want = references(jparams, jcfg, reqs)
    engine = InferenceEngine(tparams, tcfg, EngineConfig(**ekw), device="cpu")
    comps = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
    engine.run_until_idle()
    assert [c.tokens for c in comps] == want
    fleet = LocalReplicaFleet(lambda: (tparams, tcfg), engine_kwargs=ekw,
                              initial_replicas=1, device="cpu")
    try:
        assert not fleet.disaggregated
        assert "migration" not in fleet.stats()
        eng = fleet._replicas[0]
        assert eng.load()["role"] == "both"
        assert eng.engine_config == EngineConfig(**ekw)
        entries = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
        assert [e.result(timeout=WAIT) for e in entries] == want
        more = [fleet.submit(p, max_new_tokens=n) for p, n in reqs]
        assert [e.result(timeout=WAIT) for e in more] == want
    finally:
        fleet.shutdown()


def test_shutdown_unparks_waiting_exports(model):
    """A shipment that cannot land (the decode pool is down and not
    relaunched) stays parked on the prefill replica until shutdown, which
    un-parks it, so the drains finish; the request ends as the fleet
    decided, and nothing stays pinned."""
    fleet = _fleet(model, relaunch=False,
                   policy=dict(max_attempts=1000, backoff_base_s=0.01,
                               backoff_max_s=0.01))
    try:
        fleet._replicas[1].shutdown(drain=False)
        entry = fleet.submit([1, 2, 3, 4, 5], max_new_tokens=4)
        src = fleet._replicas[0]
        wait_for(lambda: fleet._migrations)  # the export was adopted
        assert fleet.migration_stats.migrated == 0
    finally:
        fleet.shutdown()
    assert entry.done and entry.disposition == "completed"
    stats = src.pool.allocator.stats()
    assert stats["chains_pinned"] == 0 and src.pool.occupancy == 0
