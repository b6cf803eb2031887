"""The port's multi-tenant QoS (ray_lightning_tpu_torch/serving/tenancy.py,
the scheduler's DRR path, the engine's tenant submit) held against the JAX
package's on the same clock, the same fake pool and the same tiny model.

Each scenario runs once through each package and the two traces must be
equal; the JAX package's own assertions (tests/test_tenancy.py) are kept on
the port's side.
"""
import pytest
import torch

from ray_lightning_tpu.serving import resilience as jax_resilience
from ray_lightning_tpu.serving import scheduler as jax_scheduler
from ray_lightning_tpu.serving import tenancy as jax_tenancy
from ray_lightning_tpu_torch.serving import resilience as port_resilience
from ray_lightning_tpu_torch.serving import scheduler as port_scheduler
from ray_lightning_tpu_torch.serving import tenancy as port_tenancy
from torch_serving_helpers import (
    jax_engine,
    port_engine,
    record_ticks,
    reference,
    tiny_models,
    two_threads,
)

pytestmark = pytest.mark.serving

PACKAGES = {
    "jax": (jax_tenancy, jax_scheduler, jax_resilience),
    "port": (port_tenancy, port_scheduler, port_resilience),
}


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(scenario):
    """Run ``scenario(tenancy, scheduler, resilience)`` for each package;
    assert the traces equal and return the port's."""
    jax_out = scenario(*PACKAGES["jax"])
    port_out = scenario(*PACKAGES["port"])
    assert port_out == jax_out
    return port_out


# --------------------------------------------------------------------- #
# token bucket, specs, grammar, registry (scripted clock)
# --------------------------------------------------------------------- #
def _bucket_script(ten, _sched, _res):
    clock = _Clock()
    bucket = ten.TokenBucket(rate=2.0, capacity=4.0, clock=clock)
    out = [bucket.try_acquire() for _ in range(5)]
    clock.t = 1.0
    out.append(round(bucket.tokens(), 12))
    out += [bucket.try_acquire() for _ in range(3)]
    clock.t = 100.0
    out.append(bucket.tokens())
    zero = ten.TokenBucket(rate=0.0, capacity=2.0, clock=clock)
    out += [zero.try_acquire() for _ in range(2)]
    clock.t = 1e6
    out.append(zero.try_acquire())
    back = ten.TokenBucket(rate=1.0, capacity=1.0, clock=_Clock(10.0))
    out.append(back.try_acquire())
    back._clock = _Clock(5.0)
    out.append(back.tokens())
    return out + [bucket.acquired_total, bucket.refused_total]


def test_token_bucket_matches_jax():
    out = _both(_bucket_script)
    assert out[:5] == [True] * 4 + [False]
    assert out[5] == pytest.approx(2.0)
    assert out[6:9] == [True, True, False]
    assert out[9] == pytest.approx(4.0)
    assert out[10:13] == [True, True, False]
    assert out[13] is True and out[14] == pytest.approx(0.0)
    assert out[15:] == [6, 2]


SPEC_CASES = [
    dict(name=""), dict(name="x", tenant_class="platinum"),
    dict(name="x", weight=0.0), dict(name="x", rate=-1.0),
    dict(name="x", burst=0.5), dict(name="x"), dict(name="x", rate=0.5),
    dict(name="x", rate=8.0), dict(name="x", rate=8.0, burst=2.0),
]


@pytest.mark.parametrize("kw", SPEC_CASES,
                         ids=[str(i) for i in range(len(SPEC_CASES))])
def test_tenant_spec_validation_matches_jax(kw):
    def script(ten, _s, _r):
        try:
            return ("ok", ten.TenantSpec(**kw).resolved_burst())
        except ValueError as e:
            return ("ValueError", str(e))

    _both(script)


GRAMMAR = [
    "gold:guaranteed:4:50,free:best_effort:1:5:10", "solo:standard",
    "gold:guaranteed:4,silver:standard:2,free:best_effort:1:0:4",
    "nocolon", " , ", "a:standard,b:platinum", "a:standard:0",
    "a:best_effort::3", "a:standard:1::2",
]


@pytest.mark.parametrize("text", GRAMMAR,
                         ids=[str(i) for i in range(len(GRAMMAR))])
def test_parse_tenant_specs_matches_jax(text):
    def script(ten, _s, _r):
        try:
            return [(s.name, s.tenant_class, s.weight, s.rate, s.burst)
                    for s in ten.parse_tenant_specs(text)]
        except ValueError as e:
            return ("ValueError", str(e))

    _both(script)


def _registry_script(ten, _s, _r):
    clock = _Clock()
    reg = ten.TenantRegistry([
        ten.TenantSpec("gold", tenant_class="guaranteed"),
        ten.TenantSpec("metered", rate=0.0, burst=2.0),
    ], clock=clock)
    out = [reg.tenant_class("drive-by"), reg.weight("drive-by"),
           reg.admit("drive-by"), "drive-by" in reg.names(),
           reg.tenant_class(None), reg.weight(None), reg.admit(None)]
    out += [reg.admit("metered") for _ in range(3)]
    return out + [dict(reg.admitted), dict(reg.quota_rejected)]


def test_registry_matches_jax():
    out = _both(_registry_script)
    assert out[:7] == ["standard", 1.0, True, True, None, 1.0, True]
    assert out[7:10] == [True, True, False]
    assert out[10] == {"drive-by": 1, "metered": 2}
    assert out[11] == {"metered": 1}


# --------------------------------------------------------------------- #
# tenant-class shed ordering
# --------------------------------------------------------------------- #
def test_shed_classes_match_jax():
    def script(_t, _s, res):
        policy = res.ShedPolicy()
        return [policy.should_shed(prio, depth, 100, slo_breached=burn,
                                   tenant_class=cls)
                for cls in (None, "standard", "guaranteed", "best_effort")
                for burn in (False, True)
                for prio in (0, 1, 5)
                for depth in (0, 69, 70, 89, 90, 100)]

    out = _both(script)
    assert len(out) == 4 * 2 * 3 * 6
    policy = port_resilience.ShedPolicy()
    assert not any(policy.should_shed(p, d, 100, slo_breached=b,
                                      tenant_class="guaranteed")
                   for p in (0, 1, 5) for d in (0, 90, 100)
                   for b in (False, True))
    assert policy.should_shed(0, 70, 100, tenant_class="best_effort")
    assert not policy.should_shed(0, 69, 100, tenant_class="best_effort")
    assert not policy.should_shed(5, 70, 100, tenant_class="standard")


# --------------------------------------------------------------------- #
# DRR on one fake pool (tests/test_tenancy.py's cases)
# --------------------------------------------------------------------- #
class _FakeSlot:
    def __init__(self, index):
        self.index = index
        self.trace = None


class _FakePool:
    """Grants up to ``per_tick`` acquisitions between ``reset_tick()``
    calls, and refuses prompts at or above ``refuse_at`` outright."""

    max_len = 1 << 20

    def __init__(self, per_tick=1 << 20, refuse_at=1 << 19):
        self.per_tick = per_tick
        self.refuse_at = refuse_at
        self.granted_this_tick = 0
        self._next = 0
        self.occupancy = 0

    def reset_tick(self):
        self.granted_this_tick = 0

    def acquire(self, request_id, prompt_len, max_new_tokens, **kw):
        if prompt_len >= self.refuse_at:
            return None
        if self.granted_this_tick >= self.per_tick:
            return None
        self.granted_this_tick += 1
        self._next += 1
        return _FakeSlot(self._next)

    def active_slots(self):
        return []


def _flood(sched_mod, sched, tenant, n, start=0, prompt_len=4):
    for i in range(n):
        sched.submit(sched_mod.Request(
            request_id=f"{tenant or 'none'}-{start + i}",
            tokens=(1,) * prompt_len, max_new_tokens=4, tenant=tenant))


def _drr_run(ten, sched_mod, weights, ticks, per_tick, max_prefills,
             flood, **kw):
    reg = ten.TenantRegistry([ten.TenantSpec(n, weight=w)
                              for n, w in weights.items()])
    pool = _FakePool(per_tick=per_tick)
    sched = sched_mod.ContinuousBatchScheduler(
        pool, max_queue=1 << 16, max_prefills_per_tick=max_prefills, **kw)
    sched.configure_tenants(reg)
    for name, n in flood.items():
        _flood(sched_mod, sched, name, n)
    seq = []
    for _ in range(ticks):
        pool.reset_tick()
        seq.append([r.request_id for r, _ in sched.tick().prefills])
    return seq, dict(sched.admitted_by_tenant), sched.has_work()


@pytest.mark.parametrize("weights", [
    {"gold": 4.0, "silver": 2.0, "bronze": 1.0},
    {"gold": 4.0, "silver": 1.5, "bronze": 1.0, "scrap": 0.5},
], ids=["integer", "fractional"])
def test_drr_sequence_and_weights_match_jax(weights):
    ticks = 600
    seq, admitted, _ = _both(lambda t, s, r: _drr_run(
        t, s, weights, ticks, 1 << 20, 2,
        {n: 2 * ticks + 16 for n in weights}))
    total = sum(admitted.values())
    assert total == 2 * ticks
    wsum = sum(weights.values())
    for name, w in weights.items():
        assert admitted[name] / total == pytest.approx(w / wsum, rel=0.10)


def test_drr_pool_blocked_ticks_match_jax():
    ticks = 400
    seq, admitted, _ = _both(lambda t, s, r: _drr_run(
        t, s, {"gold": 3.0, "bronze": 1.0}, ticks, 1, 4,
        {"gold": ticks + 8, "bronze": ticks + 8}))
    assert admitted["bronze"] > 0
    assert admitted["gold"] / admitted["bronze"] == pytest.approx(3.0,
                                                                  rel=0.10)


def test_drr_head_aging_matches_jax():
    def script(ten, sched_mod, _r):
        reg = ten.TenantRegistry([ten.TenantSpec("a", weight=1.0)])
        pool = _FakePool()
        pool.refuse_at = 100
        sched = sched_mod.ContinuousBatchScheduler(
            pool, max_queue=1 << 16, max_prefills_per_tick=1,
            head_skip_limit=4, head_aging_ticks=2)
        sched.configure_tenants(reg)
        _flood(sched_mod, sched, "a", 1, prompt_len=100)
        _flood(sched_mod, sched, "a", 3, start=1, prompt_len=4)
        admitted = []
        for _ in range(8):
            pool.reset_tick()
            admitted += [r.request_id for r, _ in sched.tick().prefills]
        return admitted, sched.tenant_depths(), sched.deferred_total

    admitted, depths, deferred = _both(script)
    assert admitted == ["a-1", "a-2"]
    assert depths["a"] == 2 and deferred >= 3


def test_drr_retires_drained_tenants_matches_jax():
    seq, admitted, has_work = _both(lambda t, s, r: _drr_run(
        t, s, {"burst": 8.0, "steady": 1.0}, 5, 1 << 20, 1,
        {"burst": 1, "steady": 4}))
    assert admitted == {"burst": 1, "steady": 4}
    assert not has_work


def test_drr_moves_backlog_and_bounds_queue_matches_jax():
    def script(ten, sched_mod, _r):
        reg = ten.TenantRegistry([ten.TenantSpec("t", weight=1.0)])
        pool = _FakePool()
        sched = sched_mod.ContinuousBatchScheduler(pool, max_queue=4)
        _flood(sched_mod, sched, "t", 2)  # queued before tenancy lands
        sched.configure_tenants(reg)
        _flood(sched_mod, sched, "t", 2, start=2)
        try:
            _flood(sched_mod, sched, "t", 1, start=4)
            full = False
        except sched_mod.RequestQueueFull:
            full = True
        depths = sched.tenant_depths()
        pool.reset_tick()
        return full, depths, [r.request_id for r, _ in sched.tick().prefills]

    assert _both(script) == (True, {"t": 4}, ["t-0"])


def test_scheduler_without_registry_is_the_fifo():
    """No registry: the single FIFO, no per-tenant state touched."""
    pool = _FakePool(per_tick=1)
    sched = port_scheduler.ContinuousBatchScheduler(pool, max_queue=8)
    sched.configure_tenants(None)
    _flood(port_scheduler, sched, "t", 3)
    order = []
    for _ in range(3):
        pool.reset_tick()
        order += [r.request_id for r, _ in sched.tick().prefills]
    assert order == ["t-0", "t-1", "t-2"]
    assert sched.tenant_depths() == {} and sched.admitted_by_tenant == {}


# --------------------------------------------------------------------- #
# the engine with a registry, against the JAX engine
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def model():
    prev = two_threads()
    yield tiny_models()
    torch.set_num_threads(prev)


TENANTS = "gold:guaranteed:4,silver:standard:2,free:best_effort:1:0:2"


def _tenant_run(engine, ten, jparams, jcfg):
    """9 requests, 3 a tenant, submitted at once over 2 slots: the per-tick
    admissions, the refused set and the streams."""
    ticks = record_ticks(engine)
    engine.configure_tenants(ten.TenantRegistry(
        ten.parse_tenant_specs(TENANTS)))
    comps, refused = {}, []
    for i in range(3):
        for tenant in ("gold", "silver", "free"):
            rid = f"{tenant}-{i}"
            prompt = [2 + i, 3 + len(tenant), 5, 7 + i]
            try:
                comps[rid] = (engine.submit(prompt, max_new_tokens=4,
                                            request_id=rid, tenant=tenant),
                              prompt)
            except ten.QuotaExceeded:
                refused.append(rid)
    engine.run_until_idle()
    streams = {rid: (c.finish_reason, c.tenant, list(c.tokens))
               for rid, (c, _) in comps.items()}
    for rid, (c, prompt) in comps.items():
        assert c.tokens == reference(jparams, jcfg, prompt, 4), rid
    return [t for t in ticks if t], refused, streams


def test_engine_with_tenants_matches_jax_engine(model):
    jparams, jcfg, tparams, tcfg = model
    kw = dict(num_slots=2, max_queue=16)
    want = _tenant_run(jax_engine(jparams, jcfg, **kw), jax_tenancy,
                       jparams, jcfg)
    got = _tenant_run(port_engine(tparams, tcfg, **kw), port_tenancy,
                      jparams, jcfg)
    assert got == want
    admissions, refused, streams = got
    assert refused == ["free-2"]
    assert all(reason == "length" for reason, _, _ in streams.values())
    # gold is admitted first and outpaces silver by its weight
    flat = [rid for tick in admissions for rid in tick]
    assert flat[0] == "gold-0"
    assert flat.index("gold-2") < flat.index("silver-1")


def test_engine_quota_refusal_is_not_a_shed(model):
    _, _, tparams, tcfg = model
    engine = port_engine(tparams, tcfg, num_slots=1, max_queue=4)
    clock = _Clock()
    registry = port_tenancy.TenantRegistry([
        port_tenancy.TenantSpec("metered", rate=0.0, burst=1.0),
        port_tenancy.TenantSpec("gold", tenant_class="guaranteed"),
    ], clock=clock)
    engine.configure_tenants(registry)
    engine.submit([1, 2], max_new_tokens=2, tenant="metered")
    with pytest.raises(port_tenancy.QuotaExceeded) as info:
        engine.submit([1, 2], max_new_tokens=2, tenant="metered")
    assert isinstance(info.value, port_scheduler.RequestQueueFull)
    assert not isinstance(info.value, port_resilience.RequestShed)
    # guaranteed traffic is never shed, even past the watermark
    for _ in range(3):
        engine.submit([3], max_new_tokens=1, tenant="gold", priority=5)
    with pytest.raises(port_scheduler.RequestQueueFull):
        engine.submit([3], max_new_tokens=1, tenant="gold")
    assert registry.quota_rejected == {"metered": 1}
    engine.run_until_idle()
    assert engine.scheduler.admitted_by_tenant == {"metered": 1, "gold": 3}
    # a front door that charges the quota itself installs admission=False
    engine2 = port_engine(tparams, tcfg, num_slots=1)
    engine2.configure_tenants(registry, admission=False)
    engine2.submit([1, 2], max_new_tokens=1, tenant="metered")
    assert registry.quota_rejected == {"metered": 1}
